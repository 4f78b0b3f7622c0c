"""Multi-process training over torch.distributed (counterpart of
textualdegremoval_tpu/parallel): the rendezvous and the backend rule
(`bootstrap`), data parallelism (`mesh`) and FSDP (`fsdp`)."""

from textualdegremoval_tpu_torch.parallel.bootstrap import (
    barrier, init_distributed, is_main_process, rank, resolve_rendezvous,
    world,
)
from textualdegremoval_tpu_torch.parallel.mesh import (
    all_reduce_mean, broadcast_, replicate,
)

__all__ = [
    "barrier", "init_distributed", "is_main_process", "rank",
    "resolve_rendezvous", "world", "all_reduce_mean", "broadcast_",
    "replicate",
]
