"""The port's multi-process training steps on the CPU, two gloo ranks,
each a process of tests/torch_dist_worker.py (torch and the port only):

* the data-parallel step of the tiny RestormerRefFusion, each rank on
  half of the batch, against JAX's `make_train_step` on the whole batch
  (the bounds of test_torch_train.test_train_step_matches_jax), and the
  two planted reduce faults (no division by the world size; a reduce of a
  stale copy) outside those bounds;
* the FSDP step against the replicated step on the whole batch, with
  leaves actually sharded and each rank's moments at 1/world of them, its
  checkpoint in the replicated layout;
* SFNet's train-mode step: the BatchNorm moments over the global batch,
  the running statistics equal to the single-process step's;
* the guidance micro-step under MultiSteps(2): the ranks' trainables
  equal after the accumulation boundary (ROADMAP C14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.losses import build_loss as j_build_loss
from textualdegremoval_tpu.models.restormer import (
    RestormerRefFusion as JRestormerRefFusion,
)
from textualdegremoval_tpu.train import schedules as jsched
from textualdegremoval_tpu.train.trainer import (
    build_optimizer as j_build_optimizer,
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)

from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models.sfnet import SFNetRefFusion
from textualdegremoval_tpu_torch.train.checkpoint import CheckpointManager
from textualdegremoval_tpu_torch.train.trainer import make_train_step

import torch_dist_worker as dw
from test_torch_guidance_train import guidance_batch
from test_torch_sfnet import TINY_REF as SFNET_TINY, trained_scale
from test_torch_train import TINY_REF, _batch, _flat, _tiny
from torch_port_util import t, torch_share

WORLD = 2
SCHED = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 10],
         "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
LOSS = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}
NET = {"type": "RestormerRefFusion", **TINY_REF}


def _restormer_input():
    model = _tiny(1)
    return model, {"net": NET, "sd": model.state_dict(), "batch": _batch(2),
                   "sched": SCHED, "loss": LOSS}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's step on the whole batch (test_train_step_matches_jax's)."""
    model, inp = _restormer_input()
    params = convert_state_dict(model.state_dict())
    tx = j_build_optimizer(params, jsched.build_schedule(2e-4, SCHED),
                           jsched.build_schedule(1e-4, SCHED))
    jstep = j_make_train_step(JRestormerRefFusion(**TINY_REF).apply,
                              j_build_loss(LOSS), tx, ema_decay=0.9,
                              donate=False)
    jstate, jm = jstep(j_create_train_state(params, tx),
                       {k: jnp.asarray(v) for k, v in inp["batch"].items()})
    return jstate, jm


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_restormer")
    torch.save(_restormer_input()[1], work / "input.pt")
    return dw.spawn("restormer_dp", work, WORLD)


def _max_diffs(out, jstate):
    """(max |param - JAX's|, max |EMA - JAX's|) over every leaf."""
    got = convert_state_dict(out["params"])
    got_ema = convert_state_dict(out["ema"])
    pairs = zip(_flat(got), _flat(jstate.params), _flat(got_ema),
                _flat(jstate.ema_params))
    dp = de = 0.0
    for (path, g), (_, w), (_, e), (_, we) in pairs:
        dp = max(dp, float(np.abs(g - w).max()))
        de = max(de, float(np.abs(e - we).max()))
    return dp, de


def test_dp_step_matches_jax_whole_batch(dp_ranks, jax_step):
    """Two ranks on one image each against JAX on both: the loss is the
    global mean and the update reads the averaged gradient.  Bounds as
    test_train_step_matches_jax's: the loss rel 1e-5 and the norm rel
    1e-4 (f32 sums in other orders), the parameters atol 2e-6 (the
    clipped Adam update is about lr = 2e-4 per element; an element whose
    gradient is near 0 may take its sign from noise), the EMA 2e-7."""
    jstate, jm = jax_step
    for out in dp_ranks:
        assert out["l_pix"] == pytest.approx(float(jm["l_pix"]), rel=1e-5)
        assert out["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                                 rel=1e-4)
        dp, de = _max_diffs(out, jstate)
        assert dp <= 2e-6 and de <= 2e-7, (dp, de)
    # the ranks hold one model
    for k, v in dp_ranks[0]["params"].items():
        assert torch.equal(v, dp_ranks[1]["params"][k]), k


@pytest.mark.parametrize("plant", sorted(dw.PLANTS))
def test_planted_reduce_faults_are_caught(dp_ranks, jax_step, plant):
    """A reduce that sums without dividing, or that reduces a stale copy
    (each rank then steps on its own gradient and logs its own loss),
    fails the bounds above on every rank.  The sum doubles the loss and
    the norm; Adam's first update, m / sqrt(v), does not see the scale of
    the gradient, so there the metrics catch it."""
    jstate, jm = jax_step
    caught = []
    for out in dp_ranks:
        got = out["plants"][plant]
        dp, de = _max_diffs(got, jstate)
        caught.append(
            got["l_pix"] != pytest.approx(float(jm["l_pix"]), rel=1e-5)
            or got["grad_norm"] != pytest.approx(float(jm["grad_norm"]),
                                                 rel=1e-4)
            or dp > 2e-6 or de > 2e-7)
    assert all(caught), plant


def _replicated_step(inp, ema_decay=0.9):
    """The single-process port step on the whole batch."""
    state = dw._restoration_state(inp, ema_decay)
    step = make_train_step(build_loss(inp["loss"]), ema_decay=ema_decay)
    with torch_share():
        return step(state, {k: t(v) for k, v in inp["batch"].items()})


@pytest.fixture(scope="module")
def fsdp_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp_restormer")
    torch.save(_restormer_input()[1], work / "input.pt")
    return work, dw.spawn("fsdp", work, WORLD)


def test_fsdp_step_matches_replicated(fsdp_ranks):
    """Each rank's slices of the parameters and the EMA against the same
    slices of the replicated step on the whole batch, within the DP
    bounds; JAX's rule picks each leaf's dimension, at least one leaf is
    sharded, and a sharded leaf's moments on a rank are 1/world of it."""
    _, ranks = fsdp_ranks
    _, inp = _restormer_input()
    state, m = _replicated_step(inp)
    full = dict(zip(state.opt.names, state.opt.params))
    ema = dict(zip(state.opt.names, state.ema))
    sharded = 0
    for r, out in enumerate(ranks):
        assert out["l_pix"] == pytest.approx(float(m["l_pix"]), rel=1e-5)
        assert out["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=1e-4)
        for name, d in out["dims"].items():
            want, want_ema = full[name].detach(), ema[name]
            if d is not None:
                k = want.shape[d] // WORLD
                want = want.narrow(d, r * k, k)
                want_ema = want_ema.narrow(d, r * k, k)
                assert out["mu"][name].numel() * WORLD == full[name].numel()
                sharded += 1
            torch.testing.assert_close(out["slices"][name], want, rtol=0,
                                       atol=2e-6, msg=name)
            torch.testing.assert_close(out["ema"][name], want_ema, rtol=0,
                                       atol=2e-7, msg=name)
        held = out["held"]
        assert held["params"] < sum(p.numel() * 4 for p in full.values())
    assert sharded > 0


def test_fsdp_checkpoint_is_the_replicated_layout(fsdp_ranks):
    """The sharded state's state_1.pth (rank 0 wrote it, gathered) loads
    into a replicated TrainState, its slices equal bit for bit to each
    rank's; net_g_1.pth loads strict; a fresh sharded state restored from
    it holds the same slices, moments and EMA."""
    work, ranks = fsdp_ranks
    _, inp = _restormer_input()
    state = dw._restoration_state(inp, 0.9)
    CheckpointManager(str(work / "ckpt/states")).restore_state(state)
    assert state.step == 1 and state.opt.count == 1
    full = dict(zip(state.opt.names, state.opt.params))
    for r, out in enumerate(ranks):
        assert out["restored_equal"] and out["restored_step"] == 1
        for name, d in out["dims"].items():
            want = full[name].detach()
            if d is not None:
                k = want.shape[d] // WORLD
                want = want.narrow(d, r * k, k)
            assert torch.equal(out["slices"][name], want), name
    net = torch.load(work / "ckpt/models/net_g_1.pth", weights_only=True)
    dw._restoration_state(inp, 0.9).model.load_state_dict(net["params"],
                                                          strict=True)


def _sfnet_input():
    model = trained_scale(SFNetRefFusion(**SFNET_TINY), 17)
    rng = np.random.default_rng(20)
    batch = {k: rng.random((4, 32, 32, 3), np.float32)
             for k in ("lq", "ref", "gt")}
    return {"net": {"type": "SFNetRefFusion", **SFNET_TINY},
            "sd": model.state_dict(), "batch": batch, "loss": LOSS}


def test_sfnet_batchnorm_moments_are_global(tmp_path):
    """Two ranks on two images each against one process on four, with the
    bounds of test_torch_sfnet_train's step against JAX: the loss and the
    global norm rel 1e-5, each averaged gradient within 5e-4 of its norm
    in L2 plus 1e-6 of the global norm (the SCM's last conv bias has no
    gradient in exact arithmetic: its InstanceNorm subtracts it), and every
    BatchNorm running statistic atol 1e-6, equal on the two ranks.  With
    each rank's own moments these would differ between the ranks."""
    inp = _sfnet_input()
    torch.save(inp, tmp_path / "input.pt")
    ranks = dw.spawn("sfnet", tmp_path, WORLD)
    state = dw._restoration_state(inp, 0.0)
    with torch_share():
        state, m, grads = dw.step_with_grads(
            make_train_step(build_loss(LOSS)), state,
            {k: t(v) for k, v in inp["batch"].items()})
    total = float(m["grad_norm"])
    stats = {k: v for k, v in state.model.state_dict().items()
             if "running_" in k}
    assert stats
    for out in ranks:
        assert out["l_pix"] == pytest.approx(float(m["l_pix"]), rel=1e-5)
        assert out["grad_norm"] == pytest.approx(total, rel=1e-5)
        for k, w in grads.items():
            err = float((out["grads"][k] - w).norm())
            assert err <= 5e-4 * float(w.norm()) + 1e-6 * total, k
        for k, v in stats.items():
            torch.testing.assert_close(out["params"][k], v, rtol=0,
                                       atol=1e-6)
    for k in stats:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k


def test_guidance_ranks_stay_equal_after_accumulation(tmp_path):
    """MultiSteps(2) on each of two ranks, each on its own two
    micro-batches: after the boundary the ranks' trainables are equal bit
    for bit (JAX's guidance step has no collective and lets them drift:
    ROADMAP C14) and match one process accumulating all four micro-batches
    (MultiSteps(4), the same draws): the mean of the same gradients, so
    saturated updates (>= 0.9 lr) within 1e-2 lr and every element within
    0.5 lr (Adam's first update is lr sign(g) where |g| >> eps)."""
    lr, per = 1e-3, 2
    batches = [guidance_batch(seed=30 + i) for i in range(WORLD * per)]
    seeds = [40 + i for i in range(WORLD * per)]
    torch.save({"k": per, "micro": per, "batches": batches, "seeds": seeds},
               tmp_path / "input.pt")
    ranks = dw.spawn("guidance", tmp_path, WORLD)
    with torch_share():
        mods, opt = dw.tiny_guidance(WORLD * per)
        from textualdegremoval_tpu_torch.diffusion.pipeline import partition
        before = {n: p.detach().clone()
                  for n, p in partition(mods, "i2t")[0]}
        dw.guidance_micro_steps(
            mods, opt, [{k: t(v) for k, v in b.items()} for b in batches],
            [torch.Generator().manual_seed(s) for s in seeds])
        want = dict(partition(mods, "i2t")[0])
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
        upd, wupd = p - before[n], want[n].detach() - before[n]
        assert wupd.abs().max() > 0, n
        sat = wupd.abs() >= 0.9 * lr
        if sat.any():
            assert float((upd - wupd)[sat].abs().max()) <= 1e-2 * lr, n
        assert float((upd - wupd).abs().max()) <= 0.5 * lr, n


def test_c14_jax_guidance_step_has_no_collective():
    """ROADMAP C14, JAX's side: its guidance step averages nothing over
    processes (no pmean or psum, no mesh), so under several processes
    each updates its own copy on its own shard.  The port averages
    (test_guidance_ranks_stay_equal_after_accumulation)."""
    import inspect

    from textualdegremoval_tpu.diffusion import pipeline as jpipe

    src = inspect.getsource(jpipe)
    assert "make_guidance_train_step" in src
    for collective in ("pmean", "psum", "all_reduce", "Mesh"):
        assert collective not in src, collective
