"""PyTorch port vs JAX package: SFNetRefFusion's training step against JAX's
`make_train_step` with `model_state` (the loss over three scales, every
gradient, the BN batch_stats), ROADMAP C11 (the JAX training CLI cannot
step an SFNet; the port's step updates its BN statistics), and the
evaluation CLI's two dehaze tasks against the JAX CLI.  Weights at a
trained network's scale (tests/test_torch_sfnet.py `trained_scale`); JAX
parameters and batch_stats from the port's state dict through the JAX
converter, never `model.init`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.losses import build_loss as j_build_loss
from textualdegremoval_tpu.models import sfnet as js
from textualdegremoval_tpu.train.trainer import (
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)

from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import sfnet as ps
from textualdegremoval_tpu_torch.train import schedules as sched
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_train_step,
)

from test_torch_sfnet import TINY_REF, trained_scale, variables
from torch_port_util import assert_close, t


def _grads_of_step(step, state, batch):
    """Run the port's step, returning (state, metrics, the raw gradients
    by parameter name as the step hands them to the optimizer)."""
    seen = {}
    update = state.opt.step

    def capture(gs):
        seen.update(zip(state.opt.names, gs))
        update(gs)

    state.opt.step = capture
    state, m = step(state, batch)
    del state.opt.step
    return state, m, seen


def test_train_step_matches_jax_trainer():
    """One step of the tiny SFNetRefFusion at batch 2 against JAX's
    `make_train_step` with model_state={'batch_stats': ...} and a
    use_running_average=False network (the JAX trainer's own SFNet
    test): L1 summed over the three scales with gt resized by
    jax.image.resize's antialiased bilinear, every gradient (JAX's taken
    by a transform that keeps them as its state), the loss and the global
    norm to 1e-5, and the updated BN statistics to 1e-6.  Each gradient
    within 5e-4 of its norm in L2, plus 1e-6 of the global norm for those
    that vanish in exact arithmetic (the SCM's last conv bias, whose
    InstanceNorm subtracts it: rounding alone) or nearly (the dynamic
    filters' 1x1 before BN at batch 2)."""
    model = trained_scale(ps.SFNetRefFusion(**TINY_REF), 17)
    rng = np.random.default_rng(18)
    batch = {k: rng.random((2, 32, 32, 3), np.float32)
             for k in ("lq", "ref", "gt")}
    loss_opt = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}
    v = variables(model)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jstep = j_make_train_step(
        js.SFNetRefFusion(**TINY_REF, use_running_average=False).apply,
        j_build_loss(loss_opt), keep, donate=False)
    jstate, jm = jstep(
        j_create_train_state(v["params"], keep,
                             model_state={"batch_stats": v["batch_stats"]}),
        {k: jnp.asarray(a) for k, a in batch.items()})

    s_lr = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 10],
            "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
    opt = build_optimizer(model, sched.build_schedule(2e-4, s_lr),
                          sched.build_schedule(1e-4, s_lr))
    state, m, grads = _grads_of_step(
        make_train_step(build_loss(loss_opt)), create_train_state(model, opt),
        {k: t(a) for k, a in batch.items()})

    assert float(m["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    total = float(jm["grad_norm"])
    for path, g in _leaves(convert_state_dict(grads)):
        w = _at(jstate.opt_state, path)
        assert np.linalg.norm(g - w) <= 5e-4 * np.linalg.norm(w) \
            + 1e-6 * total, "/".join(path)
    stats = variables(state.model)["batch_stats"]
    for path, s in _leaves(stats):
        assert_close(s, _at(jstate.model_state["batch_stats"], path),
                     atol=1e-6, rtol=0)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_c11_port_step_updates_batch_stats_where_jax_cli_cannot_step():
    """ROADMAP C11: the JAX training CLI keeps only the `params`
    collection and builds its state without model_state, so its SFNet's
    first apply cannot find the BN statistics; the port's step (train
    mode) updates running_mean and running_var."""
    import flax.errors

    from textualdegremoval_tpu.models import define_network as j_define

    opt = {"type": "SFNetRefFusion", "num_res": 1, "base_channel": 8,
           "nf": 8, "ext_n_blocks": [1, 1, 1],
           "reffusion_n_blocks": [1, 1, 1], "lr_block_size": 4}
    model = trained_scale(define_network(opt), 19)
    rng = np.random.default_rng(20)
    batch = {k: rng.random((2, 32, 32, 3), np.float32)
             for k in ("lq", "ref", "gt")}
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running_" in k}
    tx = build_optimizer(model, lambda s: 1e-4)
    state, _ = make_train_step(build_loss({"type": "L1Loss"}))(
        create_train_state(model, tx), {k: t(a) for k, a in batch.items()})
    moved = [k for k, v in before.items()
             if not torch.equal(state.model.state_dict()[k], v)]
    assert len(moved) == len(before) > 0

    params = variables(model)["params"]  # `init(...)['params']` alone
    with pytest.raises(flax.errors.ScopeCollectionNotFound,
                       match='"mean" from collection "batch_stats"'):
        jax.jit(j_define(opt).apply)(
            {"params": params},
            *(jnp.asarray(batch[k]) for k in ("lq", "ref")))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    import cv2

    from textualdegremoval_tpu_torch.cli.evaluate import (
        TASK_TABLE, shrink_for_smoke,
    )

    root = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(0)
    for sub in ("hq", "lq", "ref"):
        (root / sub).mkdir()
    for i in range(2):
        img = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "hq" / f"{i}.png"), img)
        hazy = 0.6 * img + 0.4 * 230
        cv2.imwrite(str(root / "lq" / f"{i}.png"), hazy.astype(np.uint8))
        cv2.imwrite(str(root / "ref" / f"{i}.png"),
                    np.ascontiguousarray(img[::-1]))
    for task in ("sfnet_dehaze_indoor", "sfnet_dehaze_outdoor"):
        m = trained_scale(define_network(shrink_for_smoke(TASK_TABLE[task])),
                          seed=21)
        torch.save({"params": m.state_dict()}, root / f"{task}.pth")
    return root


@pytest.mark.parametrize("task", ["sfnet_dehaze_indoor",
                                  "sfnet_dehaze_outdoor"])
def test_evaluate_cli_matches_jax_cli(eval_dirs, task):
    """--task ... --tiny_debug (base_channel 8, num_res 1, the task's TLC
    base) on the CPU against the JAX CLI on the same checkpoint, its BN
    statistics split off by `split_batch_stats`: the last scale scored,
    PSNR and SSIM to 1e-3."""
    from textualdegremoval_tpu.cli.evaluate import main as jax_main
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", task, "--tiny_debug",
            "--hqroot", str(eval_dirs / "hq"),
            "--lqroot", str(eval_dirs / "lq"),
            "--refroot", str(eval_dirs / "ref"),
            "--checkpoint_path", str(eval_dirs / f"{task}.pth")]
    want = jax_main(argv)
    got = main(argv + ["--device", "cpu"])
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3
