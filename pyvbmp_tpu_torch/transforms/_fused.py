"""Multi-sweep fitting for the stateful transform shells (counterpart of
pyvbmp_tpu/transforms/_fused.py).

The JAX package runs ``iters`` sweeps of a pure step function in one
``lax.scan``; PyTorch runs eagerly, so here the sweeps are a host loop with
the same contract, and the ELBO trajectory reaches the host in one fetch.
The JAX scan stacks every sweep's auxiliary outputs (the assignments among
them) before keeping the last; this loop keeps only the last sweep's, so a
fit holds one sweep's assignments, not ``iters`` of them.
"""
from __future__ import annotations

import torch


def fused_fit(shell, step, nodes, iters, *data, lr=1.0):
    """Run ``iters`` VB sweeps of ``step``.

    ``step(nodes, *data, lr) -> (new_nodes, (ELBO, aux...))``.  Returns
    ``(final_nodes, aux_last, ELBOs)``: ``aux_last`` holds each auxiliary
    output's final-sweep value, ``ELBOs`` the (iters,) trajectory.  ``shell``
    is unused: it keys the JAX package's compile cache."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    ELBOs = []
    for _ in range(int(iters)):
        nodes, (ELBO, *aux) = step(nodes, *data, lr)
        ELBOs.append(ELBO)
    return nodes, tuple(aux), torch.stack(ELBOs)


def record_elbos(shell, ELBOs, verbose, label="Percent Change in ELBO = "):
    """The reference's per-sweep verbose print (after ``label``) and ELBO
    bookkeeping, from the trajectory fetched once."""
    for e in ELBOs.detach().to("cpu", torch.float64).tolist():
        if verbose:
            print(label, (e - shell.ELBO_last) / abs(shell.ELBO_last) * 100)
        shell.ELBO_last = float(e)
        shell.ELBO_save.append(float(e))
