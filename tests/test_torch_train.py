"""PyTorch port vs JAX package: losses, schedules, the optimizer, one whole
training step, the structural masa freeze and checkpoints.  f32 on the
CPU; tolerances with their reasons at each assert."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

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

from textualdegremoval_tpu_torch.convert import load_reference_checkpoint
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models.restormer import RestormerRefFusion
from textualdegremoval_tpu_torch.train import schedules as sched
from textualdegremoval_tpu_torch.train.checkpoint import CheckpointManager
from textualdegremoval_tpu_torch.train.mixing import (
    mixing_augment, sample_beta,
)
from textualdegremoval_tpu_torch.train.trainer import (
    AdamW, build_optimizer, create_train_state, make_eval_step,
    make_train_step,
)

from torch_port_util import (  # noqa: F401  (a fixture)
    randn, t, randomize, assert_close, torch_share_of_cores,
)

TINY_REF = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                heads=(1, 1, 2, 2), nf=8, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


@pytest.mark.parametrize("opt", [
    {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"},
    {"type": "L1Loss", "loss_weight": 0.5, "reduction": "sum"},
    {"type": "MSELoss", "loss_weight": 1, "reduction": "mean"},
    {"type": "PSNRLoss", "loss_weight": 0.5, "reduction": "mean"},
    {"type": "PSNRLoss", "loss_weight": 1, "reduction": "mean", "toY": True},
    {"type": "CharbonnierLoss", "loss_weight": 1, "reduction": "mean"},
])
def test_losses_match_jax(opt):
    rng = np.random.default_rng(0)
    pred, gt = rng.random((2, 9, 7, 3), np.float32), \
        rng.random((2, 9, 7, 3), np.float32)
    got = build_loss(opt)(t(pred), t(gt))
    assert_close(got, j_build_loss(opt)(pred, gt), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", [
    {"type": "MultiStepRestartLR", "milestones": [20, 60], "gamma": 0.5,
     "restarts": [0, 50], "restart_weights": [1, 0.5]},
    {"type": "LinearLR", "total_iter": 150},
    {"type": "VibrateLR", "total_iter": 400},
    {"type": "CosineAnnealingRestartLR", "periods": [50, 100],
     "restart_weights": [1, 0.5], "eta_min": 1e-7},
    {"type": "CosineAnnealingRestartCyclicLR", "periods": [50, 100],
     "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]},
    {"type": "CosineAnnealingWarmupRestarts", "periods": [80, 70],
     "restart_weights": [1, 1], "eta_mins": [1e-5, 1e-6]},
    {"type": "CosineAnnealingLRWithRestart", "periods": [150],
     "restart_weights": [1], "eta_mins": [0.0]},
])
@pytest.mark.parametrize("warmup", [-1, 10])
def test_schedules_match_jax(opt, warmup):
    base = 2e-4
    got = sched.warmup_wrap(sched.build_schedule(base, opt), warmup, base)
    want = jsched.warmup_wrap(jsched.build_schedule(base, opt), warmup, base)
    for step in (0, 1, 5, 9, 10, 11, 49, 50, 51, 99, 100, 101, 149, 160):
        # JAX evaluates in f32, the port in f64: a few f32 ulps of base
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5,
                                          abs=base * 1e-6), step


def _tree(rng):
    """The same parameters as a JAX tree and as named port parameters:
    a trunk leaf, the masa encoder, a masa fusion block."""
    leaves = {("trunk", "w"): randn(rng, 4, 3),
              ("masa_enc", "conv", "kernel"): randn(rng, 2, 5),
              ("masa_blk_enc_level1_0", "alpha"): randn(rng, 3)}
    jtree = {}
    for path, v in leaves.items():
        node = jtree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = jnp.asarray(v)
    named = [(".".join(k), torch.nn.Parameter(t(v.copy())))
             for k, v in leaves.items()]
    return leaves, jtree, named


def _jax_leaf(tree, path):
    for seg in path:
        tree = tree[seg]
    return np.asarray(tree)


@pytest.mark.parametrize("fix,clip,wd", [
    (0, 0.01, 1e-4),   # clipped (the YAML's clip is far below these norms)
    (3, 0.01, 1e-4),   # frozen masa for 3 updates, then released
    (2, None, 0.0),    # no clip, no weight decay
])
def test_optimizer_matches_optax(fix, clip, wd):
    rng = np.random.default_rng(fix)
    leaves, jtree, named = _tree(rng)
    lr, ref_lr = (lambda s: 1e-3), (lambda s: 5e-4)
    tx = j_build_optimizer(jtree, lr, ref_lr, weight_decay=wd,
                           grad_clip=clip, param_fix_iterations=fix)
    jstate = tx.init(jtree)
    opt = AdamW(named, lr, ref_lr, weight_decay=wd, grad_clip=clip,
                param_fix_iterations=fix)
    for _ in range(6):
        grads = {k: randn(rng, *v.shape) for k, v in leaves.items()}
        jg = jax.tree_util.tree_map(lambda x: x, jtree)
        for path, g in grads.items():
            node = jg
            for seg in path[:-1]:
                node = node[seg]
            node[path[-1]] = jnp.asarray(g)
        upd, jstate = tx.update(jg, jstate, jtree)
        jtree = jax.tree_util.tree_map(lambda p, u: p + u, jtree, upd)
        opt.step([t(g) for g in grads.values()])
        for (path, _), (_, p) in zip(leaves.items(), named):
            # f32 on both sides; the update is lr * O(1), summed in a
            # different order
            assert_close(p, _jax_leaf(jtree, path), rtol=1e-6, atol=1e-8)
    assert opt.count == 6


def test_first_masa_update_after_a_freeze_keeps_the_count():
    """optax advances the masa group's Adam count through the freeze while
    its moments stay zero, so after 5 frozen steps at lr 1e-3 the first
    masa update is 1e-3 * 0.1 / (1 - 0.9^6) / sqrt(0.001 / (1 - 0.999^6))
    = 5.2212e-4, not 1e-3."""
    rng = np.random.default_rng(0)
    leaves, jtree, named = _tree(rng)
    lr = lambda s: 1e-3  # noqa: E731
    tx = j_build_optimizer(jtree, lr, lr, weight_decay=0.0, grad_clip=None,
                           param_fix_iterations=5)
    jstate = tx.init(jtree)
    opt = AdamW(named, lr, lr, weight_decay=0.0, grad_clip=None,
                param_fix_iterations=5)
    masa = dict(named)["masa_enc.conv.kernel"]
    grads = [t(np.full(v.shape, 0.3, np.float32)) for v in leaves.values()]
    jg = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.3), jtree)
    for _ in range(5):
        before = masa.detach().clone()
        opt.step(grads)
        _, jstate = tx.update(jg, jstate, jtree)
        assert torch.equal(masa, before)  # frozen: no move, no decay
    before = masa.detach().clone()
    opt.step(grads)
    upd, _ = tx.update(jg, jstate, jtree)
    step = float((before - masa.detach())[0, 0])
    jstep = -float(upd["masa_enc"]["conv"]["kernel"][0, 0])
    assert jstep == pytest.approx(5.2212e-4, abs=1e-8)
    # read off an O(1) f32 parameter: within two f32 ulps of it
    assert step == pytest.approx(5.2212e-4, abs=2.5e-7)


def _tiny(seed):
    return randomize(RestormerRefFusion(**TINY_REF), seed, scale=0.2)


def _batch(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    lq = rng.random((b, hw, hw, 3), np.float32)
    return {"lq": lq, "ref": rng.random((b, hw, hw, 3), np.float32),
            "gt": np.clip(lq + 0.1 * randn(rng, b, hw, hw, 3), 0, 1)}


def test_train_step_matches_jax():
    """One step of the tiny RestormerRefFusion: L1, the YAML's optimizer
    (AdamW 2e-4 / ref 1e-4 cosine, wd 1e-4, clip 0.01), EMA 0.9."""
    model = _tiny(1)
    batch = _batch(2)
    s_lr = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 10],
            "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
    loss_opt = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}

    params = convert_state_dict(model.state_dict())
    jmodel = JRestormerRefFusion(**TINY_REF)
    tx = j_build_optimizer(params, jsched.build_schedule(2e-4, s_lr),
                           jsched.build_schedule(1e-4, s_lr))
    jstate = j_create_train_state(params, tx)
    jstep = j_make_train_step(jmodel.apply, j_build_loss(loss_opt), tx,
                              ema_decay=0.9, donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    opt = build_optimizer(model, sched.build_schedule(2e-4, s_lr),
                          sched.build_schedule(1e-4, s_lr))
    state = create_train_state(model, opt, ema_decay=0.9)
    step = make_train_step(build_loss(loss_opt), ema_decay=0.9)
    state, m = step(state, {k: t(v) for k, v in batch.items()})

    # forward and backward in f32 in other orders: the loss and the norm
    # agree to f32 summation noise
    assert float(m["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    # the clipped Adam update moves each parameter by about lr = 2e-4;
    # an element whose gradient is near 0 may get its sign from noise, so
    # the bound is on the update, with a few ulps of lr
    got = convert_state_dict(state.model.state_dict())
    got_ema = convert_state_dict(state.ema_state_dict())
    for (path, g), (_, w), (_, e), (_, we) in zip(
            _flat(got), _flat(jstate.params), _flat(got_ema),
            _flat(jstate.ema_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=path)
        np.testing.assert_allclose(e, we, rtol=0, atol=2e-7, err_msg=path)
    assert state.step == 1 and int(jstate.step) == 1


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(tree[k])


@pytest.mark.usefixtures("torch_share_of_cores")
def test_masa_frozen_step_matches_the_masked_step():
    """The structural freeze (requires_grad_(False) on the masa group)
    against the masking step: the same trunk updates (the clip sees zero
    masa gradients either way), no masa update, the same count."""
    batch = {k: t(v) for k, v in _batch(3).items()}
    loss = build_loss({"type": "L1Loss"})
    states = []
    for frozen in (True, False):
        model = _tiny(4)
        opt = build_optimizer(model, lambda s: 2e-4, lambda s: 1e-4,
                              param_fix_iterations=2)
        state = create_train_state(model, opt)
        step = make_train_step(loss, masa_frozen=frozen)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, _ = step(state, batch)
        states.append((state, before))
    (sf, bf), (sm, _) = states
    assert sf.opt.count == sm.opt.count == 1
    for (n, pf), (_, pm) in zip(sf.model.named_parameters(),
                                sm.model.named_parameters()):
        if "masa" in n:
            assert torch.equal(pf, bf[n]) and torch.equal(pm, bf[n]), n
        else:
            assert_close(pf, pm.detach(), rtol=0, atol=1e-9)
        assert pf.requires_grad  # restored after the step


@pytest.mark.usefixtures("torch_share_of_cores")
def test_checkpoint_round_trip(tmp_path):
    batch = {k: t(v) for k, v in _batch(5, b=1).items()}
    model = _tiny(6)
    opt = build_optimizer(model, lambda s: 2e-4)
    state = create_train_state(model, opt, ema_decay=0.5)
    step = make_train_step(build_loss({"type": "L1Loss"}), ema_decay=0.5)
    state, _ = step(state, batch)
    ckpt = CheckpointManager(str(tmp_path / "states"), str(tmp_path / "models"))
    ckpt.save_state(state, 1)
    net = ckpt.save_network(state, 1)

    other = _tiny(7)
    fresh = create_train_state(other, build_optimizer(other, lambda s: 2e-4),
                               ema_decay=0.5)
    assert ckpt.latest_step() == 1
    ckpt.restore_state(fresh)
    assert fresh.step == 1 and fresh.opt.count == 1
    for a, b in zip(fresh.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(fresh.opt.mu + fresh.opt.nu + fresh.ema,
                    state.opt.mu + state.opt.nu + state.ema):
        assert torch.equal(a, b)
    # the network file loads into a fresh model with strict keys, both
    # the parameters and the EMA; the EMA differs from the parameters
    m = load_reference_checkpoint(RestormerRefFusion(**TINY_REF), net)
    e = load_reference_checkpoint(RestormerRefFusion(**TINY_REF), net,
                                  key="params_ema")
    assert torch.equal(m.patch_embed.proj.weight,
                       state.model.patch_embed.proj.weight)
    assert not torch.equal(e.patch_embed.proj.weight,
                           m.patch_embed.proj.weight)
    # the eval step swaps the EMA in for the call only
    ev = make_eval_step(use_ema=True)(state, batch)
    with torch.no_grad():
        assert_close(ev, e.eval()(batch["lq"], batch["ref"]), atol=1e-6)
    assert torch.equal(m.patch_embed.proj.weight,
                       state.model.patch_embed.proj.weight)


def test_mixup_draws_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    lams = [sample_beta(1.2, gen) for _ in range(2000)]
    assert np.mean(lams) == pytest.approx(0.5, abs=0.02)  # symmetric Beta
    assert np.var(lams) == pytest.approx(1 / (4 * 3.4), rel=0.1)
    x, y = torch.rand(4, 3, 3, 1), torch.rand(4, 3, 3, 1)
    a = mixing_augment(torch.Generator().manual_seed(3), x, y)
    b = mixing_augment(torch.Generator().manual_seed(3), x, y)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_data_transforms_and_sampler_match_jax():
    """Same random.Random draws, same crops and dihedral modes; the same
    epoch-seeded sampler order (both numpy-only code)."""
    import random

    from textualdegremoval_tpu.data.sampler import EnlargedSampler as JS
    from textualdegremoval_tpu.data.transforms import (
        augment as j_augment, paired_random_crop as j_crop,
        random_augmentation as j_random_aug, reflect_pad_to as j_pad,
    )
    from textualdegremoval_tpu_torch.data.sampler import EnlargedSampler
    from textualdegremoval_tpu_torch.data.transforms import (
        augment, paired_random_crop, random_augmentation, reflect_pad_to,
    )

    rng = np.random.default_rng(0)
    gt = rng.random((20, 18, 3), np.float32)
    lq = gt * 0.5
    for seed in range(6):
        got = paired_random_crop(gt, [lq], 8, 1, random.Random(seed))
        want = j_crop(gt, [lq], 8, 1, random.Random(seed))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1][0], want[1][0])
        for g, w in zip(random_augmentation(lq, gt, rng=random.Random(seed)),
                        j_random_aug(lq, gt, rng=random.Random(seed))):
            assert np.array_equal(g, w)
        for g, w in zip(augment([lq, gt], rng=random.Random(seed)),
                        j_augment([lq, gt], rng=random.Random(seed))):
            assert np.array_equal(g, w)
    assert np.array_equal(reflect_pad_to(gt[:5], 8), j_pad(gt[:5], 8))
    for epoch in (0, 5):
        s, js = EnlargedSampler(7, 2, 1, 3), JS(7, 2, 1, 3)
        s.set_epoch(epoch)
        js.set_epoch(epoch)
        assert list(s) == list(js) and len(s) == len(js)
