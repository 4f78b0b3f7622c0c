"""Multi-process training and evaluation over torch.distributed
(counterpart of textualdegremoval_tpu/parallel): the rendezvous and the
backend rule (`bootstrap`), data parallelism (`mesh`), FSDP (`fsdp`) and
a whole-image forward split by rows (`spatial`)."""

from textualdegremoval_tpu_torch.parallel.bootstrap import (
    barrier, init_distributed, is_main_process, rank, resolve_rendezvous,
    world,
)
from textualdegremoval_tpu_torch.parallel.mesh import (
    all_reduce_mean, broadcast_, replicate,
)
from textualdegremoval_tpu_torch.parallel.spatial import (
    CollectiveTrace, RowShard, box_mean_rows, exchange_rows, gather_rows,
    halo_rows, reduce_stats, reflect_rows,
)

__all__ = [
    "barrier", "init_distributed", "is_main_process", "rank",
    "resolve_rendezvous", "world", "all_reduce_mean", "broadcast_",
    "replicate", "CollectiveTrace", "RowShard", "box_mean_rows",
    "exchange_rows", "gather_rows", "halo_rows", "reduce_stats",
    "reflect_rows",
]
