"""Device kernels a sweep launched inside the role M-step, the observation
update and the latent M-step (``dmbd.role_mstep``, ``dmbd.obs_update``,
``dmbd.latent_mstep``; ``cardbench/charge.py``)."""
from cardbench import charge


def read(ctx):
    return charge.launches_in(ctx, charge.MSTEP)
