"""Multi-process bootstrap: the reference's `init_dist` on torch.distributed.

Counterpart of textualdegremoval_tpu/parallel/bootstrap.py (reference
utils/utils_dist.py:10-58).  The rendezvous is resolved from the same
three sources, in the same order:

1. JAX-style env: COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID;
2. the torch launcher's env (torchrun, `torch.distributed.launch`):
   RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
3. slurm: SLURM_PROCID, SLURM_NTASKS and the first host of the nodelist
   through `scontrol show hostname`;

and one process (a no-op) where none describes a multi-process launch, so
every CLI calls `init_distributed` unconditionally.

The backend is a rule, not an option: nccl where every rank of a node
has a card of its own, gloo on the CPU and where a node's ranks outnumber
its cards (NCCL refuses two ranks on one device).  Each rank's device is
cuda:(local_rank % device_count), local_rank being LOCAL_RANK, else
SLURM_LOCALID, else the rank.
"""

from __future__ import annotations

import datetime
import os
import re
import subprocess

import torch
import torch.distributed as dist

_DEFAULT_PORT = 29500
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _slurm_coordinator(port: int) -> str | None:
    nodelist = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get(
        "SLURM_NODELIST")
    if not nodelist:
        return None
    try:
        host = subprocess.check_output(
            ["scontrol", "show", "hostname", nodelist], text=True
        ).split()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        # scontrol unavailable: single-name nodelists are usable directly
        if any(c in nodelist for c in "[,"):
            raise RuntimeError(
                f"cannot resolve slurm nodelist {nodelist!r} without scontrol")
        host = nodelist
    return f"{host}:{port}"


def resolve_rendezvous(port: int = _DEFAULT_PORT):
    """(coordinator 'host:port', process count, process index), or None
    where the environment describes no multi-process launch."""
    env = os.environ
    if "COORDINATOR_ADDRESS" in env:
        return (env["COORDINATOR_ADDRESS"],
                int(env.get("NUM_PROCESSES", env.get("WORLD_SIZE", 1))),
                int(env.get("PROCESS_ID", env.get("RANK", 0))))
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        p = env.get("MASTER_PORT", str(port))
        return (f"{addr}:{p}", int(env["WORLD_SIZE"]), int(env["RANK"]))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        coord = _slurm_coordinator(int(env.get("MASTER_PORT", port)))
        if coord is not None:
            return (coord, int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]))
    return None


def local_rank(rank: int) -> int:
    """The rank's index on its node: LOCAL_RANK, else SLURM_LOCALID, else
    the rank (one node)."""
    env = os.environ
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", rank)))


def local_world_size(world: int) -> int:
    """Ranks on this node: LOCAL_WORLD_SIZE, else slurm's tasks per node
    (its first count, as in '2(x3)'), else the world (one node)."""
    env = os.environ
    if "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_WORLD_SIZE"])
    per_node = env.get("SLURM_NTASKS_PER_NODE") or env.get(
        "SLURM_STEP_TASKS_PER_NODE")
    if per_node and (m := re.match(r"\d+", per_node)):
        return int(m.group(0))
    return world


def backend_for(device_type: str, ranks_on_node: int,
                cards_on_node: int) -> str:
    """nccl where each of the node's ranks has a card of its own; gloo on
    the CPU and where the ranks outnumber the cards."""
    if device_type == "cuda" and 0 < ranks_on_node <= cards_on_node:
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """The rank's device: cuda:(local_rank % device_count) on CUDA, the
    given device elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def init_distributed(device: str | torch.device = "cuda",
                     coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     port: int = _DEFAULT_PORT,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     ) -> tuple[int, int]:
    """Join the process group where the launch is multi-process; returns
    (rank, world).  Idempotent, and a no-op for one process.  `device`
    (the CLI's --device) picks the backend by `backend_for`; on CUDA the
    rank's card becomes the current device.  A rendezvous that fails or
    does not complete within `timeout` raises: a rank never carries on
    alone."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        rv = resolve_rendezvous(port)
    else:
        rv = (coordinator_address, num_processes or 1, process_id or 0)
    if rv is None or rv[1] <= 1:
        return 0, 1
    addr, world_size, rank = rv
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = backend_for(device.type, local_world_size(world_size), cards)
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device, rank))
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return rank, world_size


def world() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The rank-0 gate for I/O (the reference's @master_only)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if world() > 1:
        dist.barrier()
