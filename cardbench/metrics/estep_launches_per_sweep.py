"""Device kernels a sweep launched inside the role and latent E-steps
(``dmbd.role_estep``, ``dmbd.latent_estep``), their smoothers and scans
included (``cardbench/charge.py``)."""
from cardbench import charge


def read(ctx):
    return charge.launches_in(ctx, charge.ESTEP)
