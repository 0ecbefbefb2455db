"""The parallel layer on ``torch.distributed`` (counterpart of
pyvbmp_tpu/parallel): a ``Mesh`` of ranks, data-parallel VB sweeps
(``data_parallel_update``) and the time-sharded smoothers
(``seq_parallel``), which the models reach through ``time_mesh=``: a
time-sharded sweep keeps each rank's chunk, and ``gather_posterior``
makes a fitted model's per-time state whole."""
from .api import (
    Mesh,
    data_parallel_update,
    make_mesh,
    replicate,
    shard_batch,
    shard_pytree_batch,
)
from .seq_parallel import (
    gather_posterior,
    sharded_associative_scan,
    shift_down,
    shift_up,
    time_sharded_driven_forward_backward,
    time_sharded_forward_backward,
    time_sharded_kalman_smoother,
)

__all__ = [
    "Mesh",
    "data_parallel_update",
    "gather_posterior",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_pytree_batch",
    "sharded_associative_scan",
    "shift_down",
    "shift_up",
    "time_sharded_driven_forward_backward",
    "time_sharded_forward_backward",
    "time_sharded_kalman_smoother",
]
