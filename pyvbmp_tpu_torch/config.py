"""Global configuration for pyvbmp_tpu_torch.

The dtype of a computation follows its inputs: float32 on the card, float64
for the parity tests on the CPU.
"""
from __future__ import annotations

import os

# Jitter added to PSD matrices before Cholesky when solves go bad.
PSD_JITTER = float(os.environ.get("PYVBMP_PSD_JITTER", "0.0"))
