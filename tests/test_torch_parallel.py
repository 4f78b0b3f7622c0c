"""The port's parallel group against the JAX package's, in one process:
`resolve_rendezvous` on the environments of tests/test_bootstrap.py and
more, `fsdp_spec` against JAX's PartitionSpec over shapes and world
sizes, the backend and device rule, the no-op paths of one process, the
one train step on a sharded state, the rank-0 checkpoint copy, the
BatchNorm's switch to global moments, and the kernel build's lock raced
by two processes on a stub nvcc."""

import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from textualdegremoval_tpu.parallel import bootstrap as jboot
from textualdegremoval_tpu.parallel.fsdp import fsdp_spec as j_fsdp_spec

from textualdegremoval_tpu_torch.parallel import bootstrap as boot
from textualdegremoval_tpu_torch.parallel import mesh
from textualdegremoval_tpu_torch.parallel.fsdp import fsdp_spec
from textualdegremoval_tpu_torch.train import trainer

from torch_port_util import t

_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "RANK",
        "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID",
        "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_STEP_NODELIST",
        "LOCAL_RANK", "SLURM_LOCALID", "LOCAL_WORLD_SIZE",
        "SLURM_NTASKS_PER_NODE", "SLURM_STEP_TASKS_PER_NODE")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,port", [
    ({}, 29500),
    ({"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "12345"}, 29500),
    ({"RANK": "1", "WORLD_SIZE": "2"}, 29511),
    ({"COORDINATOR_ADDRESS": "host:1234", "NUM_PROCESSES": "8",
      "PROCESS_ID": "5"}, 29500),
    ({"COORDINATOR_ADDRESS": "host:1234", "WORLD_SIZE": "3",
      "RANK": "2"}, 29500),
    ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
      "SLURM_NODELIST": "worker0"}, 29501),
    ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
      "SLURM_STEP_NODELIST": "worker7", "MASTER_PORT": "4242"}, 29500),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1",
      "SLURM_NODELIST": "worker0"}, 29500),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "4"}, 29500),
])
def test_resolve_rendezvous_matches_jax(clean_env, env, port):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert boot.resolve_rendezvous(port) == jboot.resolve_rendezvous(port)


def test_bracketed_slurm_nodelist_without_scontrol_raises(clean_env):
    """scontrol absent: a bracketed nodelist cannot be expanded, in both
    packages."""
    for k, v in (("SLURM_PROCID", "0"), ("SLURM_NTASKS", "2"),
                 ("SLURM_NODELIST", "worker[0-1]")):
        clean_env.setenv(k, v)
    for fn in (boot.resolve_rendezvous, jboot.resolve_rendezvous):
        with mock.patch("subprocess.check_output", side_effect=OSError), \
                pytest.raises(RuntimeError, match="without scontrol"):
            fn()


def _jax_dim(spec):
    dims = [i for i, a in enumerate(spec) if a is not None]
    return dims[0] if dims else None


SHAPES = [(), (1,), (7,), (8,), (48,), (7, 9), (3, 3, 16, 32), (16, 16),
          (64, 3, 3, 3), (3, 3, 48, 48), (96, 48, 1, 1), (10240, 64),
          (5, 6, 10), (12, 12, 12), (1, 1, 1, 1)]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_fsdp_spec_matches_jax(world):
    for shape in SHAPES:
        assert fsdp_spec(shape, world) == _jax_dim(
            j_fsdp_spec(shape, world)), (shape, world)
    # tests/test_fsdp.py's cases
    assert fsdp_spec((3, 3, 16, 32), 8) == 3
    assert fsdp_spec((48,), 8) == 0
    assert fsdp_spec((7, 9), 8) is None and fsdp_spec((), 8) is None


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 4, "nccl"), ("cuda", 8, 4, "gloo"),
    ("cuda", 1, 0, "gloo"),
])
def test_backend_rule(device, ranks, cards, want):
    assert boot.backend_for(device, ranks, cards) == want


def test_rank_device_and_local_sizes(clean_env):
    with mock.patch.object(torch.cuda, "device_count", return_value=4):
        assert boot.rank_device("cuda", 6) == torch.device("cuda", 2)
        clean_env.setenv("SLURM_LOCALID", "1")
        assert boot.rank_device("cuda", 6) == torch.device("cuda", 1)
        clean_env.setenv("LOCAL_RANK", "3")
        assert boot.rank_device("cuda", 6) == torch.device("cuda", 3)
    assert boot.rank_device("cpu", 5) == torch.device("cpu")
    assert boot.local_world_size(6) == 6
    clean_env.setenv("SLURM_NTASKS_PER_NODE", "2(x3)")
    assert boot.local_world_size(6) == 2
    clean_env.setenv("LOCAL_WORLD_SIZE", "4")
    assert boot.local_world_size(6) == 4


def test_one_process_is_a_noop(clean_env):
    """Without a launch: no group, rank 0 of 1, and the collectives hand
    their input back."""
    assert boot.init_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert (boot.world(), boot.rank(), boot.is_main_process()) == (1, 0, True)
    boot.barrier()
    x = [torch.ones(3), torch.zeros(2)]
    assert mesh.all_reduce_mean(x) == x


def test_buckets_keep_order_and_size():
    ts = [torch.zeros(10), torch.zeros(3, dtype=torch.int64), torch.zeros(6),
          torch.zeros(20), torch.zeros(1)]
    got = list(mesh.buckets(ts, bucket_bytes=40))
    assert got == [[0], [2, 3], [4], [1]]


def test_single_rank_step_makes_no_collective():
    """With one rank the step never calls the reduce: the step of before,
    bit for bit (tests/test_torch_train.py holds it against JAX)."""
    from test_torch_train import _batch, _tiny

    from textualdegremoval_tpu_torch.losses import build_loss

    model = _tiny(1)
    state = trainer.create_train_state(
        model, trainer.build_optimizer(model, lambda s: 2e-4))
    step = trainer.make_train_step(build_loss({"type": "L1Loss"}))
    with mock.patch.object(trainer, "all_reduce_mean",
                           side_effect=AssertionError("reduced")):
        step(state, {k: t(v) for k, v in _batch(2).items()})
    assert state.step == 1


def test_sharded_state_takes_the_replicated_step_with_masa_frozen():
    """make_train_step on a state sharded over one rank (every leaf split
    into one slice, so every hook runs) with the masa group frozen: its
    None gradients read as zeros in the buckets, and the step equals the
    replicated state's (the norms sum in another order: 1e-6)."""
    from test_torch_train import _batch, _tiny

    from textualdegremoval_tpu_torch.losses import build_loss
    from textualdegremoval_tpu_torch.parallel.fsdp import shard_train_state

    def state():
        model = _tiny(1)
        return trainer.create_train_state(model, trainer.build_optimizer(
            model, lambda s: 2e-4, param_fix_iterations=1), ema_decay=0.9)

    batch = {k: t(v) for k, v in _batch(2).items()}
    step = trainer.make_train_step(build_loss({"type": "L1Loss"}), 0.9,
                                   masa_frozen=True)
    rep, rm = step(state(), batch)
    sharded = shard_train_state(state())
    assert all(sharded.sharded)
    sharded, sm = step(sharded, batch)
    for k in ("l_pix", "grad_norm"):
        assert float(sm[k]) == pytest.approx(float(rm[k]), rel=1e-6), k
    for name, p, e in zip(rep.opt.names, sharded.opt.params, sharded.ema):
        i = rep.opt.names.index(name)
        torch.testing.assert_close(p, rep.opt.params[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(e, rep.ema[i], rtol=0, atol=1e-6)
    assert sharded.step == rep.step == 1


def test_host_copy_is_made_on_rank_0_only():
    """A replicated state's checkpoint copy is no collective: the ranks
    other than 0, which write nothing, make none."""
    from test_torch_train import _tiny

    model = _tiny(1)
    state = trainer.create_train_state(
        model, trainer.build_optimizer(model, lambda s: 2e-4), 0.9)
    assert set(state.host_state()) == {"step", "params", "opt", "ema"}
    with mock.patch.object(trainer, "is_main_process", return_value=False):
        assert state.host_state() is None


def test_batch_moments_stay_local_until_asked():
    """SFNet's BatchNorm makes no collective of itself: the global batch
    moments are turned on by parallel.mesh (replicate, shard_train_state),
    and only under several ranks."""
    from textualdegremoval_tpu_torch.models.sfnet import BatchNorm

    net = torch.nn.Sequential(BatchNorm(4), BatchNorm(4))
    assert not any(m.across_ranks for m in net)
    mesh.global_batch_moments(net)  # one rank: no-op
    assert not any(m.across_ranks for m in net)
    with mock.patch.object(mesh, "world", return_value=2):
        mesh.global_batch_moments(net)
    assert all(m.across_ranks for m in net)
    assert not BatchNorm(4).across_ranks


_STUB_NVCC = r"""#!{python}
import os, sys, time
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.5)
with open(out, "w") as f:
    f.write("stub")
"""

_RACER = """
import sys
from pathlib import Path
from textualdegremoval_tpu_torch.ops import _build
so, secs = _build.build(Path(sys.argv[1]), Path(sys.argv[2]))
print(so.name, secs > 0)
"""


def test_build_lock_builds_once_when_raced(tmp_path):
    """Two processes build the same sources at once on a stub nvcc (it
    logs each call and sleeps): the sources compile once, one process
    reports the build, the other waits and takes its library."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, CUDA_HOME=str(cuda), STUB_NVCC_LOG=str(log),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(csrc),
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0][0] == outs[1][0]
    assert sorted(o[1] for o in outs) == ["False", "True"]
    calls = log.read_text().splitlines()
    assert sum(" -c " in f" {c} " for c in calls) == 2  # a.cu, b.cu once
    assert sum("-shared" in c for c in calls) == 1
    assert (tmp_path / "build" / outs[0][0]).exists()
    assert not list((tmp_path / "build").glob("*.tmp.so"))


def test_failed_rendezvous_raises(clean_env):
    """A rank whose coordinator never answers raises after the timeout;
    it does not carry on as one process."""
    import datetime
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        boot.init_distributed("cpu", f"127.0.0.1:{port}", 2, 1,
                              timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
