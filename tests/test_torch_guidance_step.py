"""PyTorch port vs JAX package: pipeline A's training step, on the CPU.

* One I2T and one TR update through `make_guidance_train_step` with
  `make_guidance_optimizer(accumulation_steps=2)` against JAX
  `make_guidance_train_step` over `optax.MultiSteps(make_guidance_optimizer
  (...), 2)`, two micro-steps each with JAX's draws fed in: the losses to
  1e-5 relative, no parameter moves after the first micro-step, every
  frozen parameter bitwise unchanged after the second, and each trainable
  parameter's update held as follows (lr 2e-4).  Adam's first update
  lr m / (sqrt(v) + eps) is lr sign(g) where |g| >> eps (1e-8) and turns
  a tiny difference of a gradient element near eps into a large one of its
  update (1e-9 of f32 rounding in g moves it by 0.1 lr).  So: elements
  whose JAX update is saturated (>= 0.9 lr) to 2e-6 = 1e-2 lr (measured
  5.8e-3 lr), every element to 0.5 lr (measured 0.26 lr, at gradients
  near eps), and each parameter's update to 2e-3 in L2 (measured 5.2e-4);
* `MultiSteps` against optax.MultiSteps on plain arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from textualdegremoval_tpu.diffusion import pipeline as jpipe

from textualdegremoval_tpu_torch.diffusion import pipeline
from textualdegremoval_tpu_torch.train.trainer import AdamW, MultiSteps

from test_torch_guidance_train import (
    guidance_batch, jax_draws, jax_leaf, torch_draws,
)
from torch_port_util import t, tiny_guidance_modules

LR = 2e-4


@pytest.mark.parametrize("stage", ["i2t", "tr"])
def test_update_matches_jax_multisteps(stage):
    mods, jmods, params = tiny_guidance_modules(seed=5)
    tx = optax.MultiSteps(jpipe.make_guidance_optimizer(params, stage,
                                                        lr=LR), 2)
    jstep = jpipe.make_guidance_train_step(jmods, tx, stage)
    opt_state = tx.init(params)
    jparams = jax.tree_util.tree_map(jnp.array, params)

    opt = pipeline.make_guidance_optimizer(mods, stage, lr=LR,
                                           accumulation_steps=2)
    assert isinstance(opt, MultiSteps) and opt.opt.weight_decay == 1e-2
    step = pipeline.make_guidance_train_step(mods, opt, stage)
    named = {f"{tw}.{n}": p for tw, m in mods.towers().items()
             for n, p in m.named_parameters()}
    before = {n: p.detach().clone() for n, p in named.items()}
    train = {n for n, _ in pipeline.partition(mods, stage)[0]}

    for i in range(2):
        batch = guidance_batch(seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        draws = torch_draws(jax_draws(jmods, jparams, batch, key))
        jparams, opt_state, want = jstep(
            jparams, opt_state, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, key)
        got = step({k: t(v) for k, v in batch.items()}, **draws)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        if i == 0:
            assert all(torch.equal(p, before[n]) for n, p in named.items())

    moved = 0
    for name, p in named.items():
        if name not in train:
            assert torch.equal(p, before[name]), name
            continue
        upd = (p - before[name]).detach().numpy()
        want = jax_leaf(jparams, name, p.ndim) - before[name].numpy()
        diff = np.abs(upd - want)
        saturated = np.abs(want) >= 0.9 * LR
        assert saturated.mean() > 0.5, name
        assert diff[saturated].max() <= 2e-6, (name, diff[saturated].max())
        assert diff.max() <= 0.5 * LR, (name, diff.max())
        assert np.linalg.norm(upd - want) <= 2e-3 * np.linalg.norm(want)
        moved += bool(np.any(upd))
    assert moved == len(train)


def test_multisteps_matches_optax():
    """Three windows of k = 3 micro-steps over two arrays: the running
    mean of optax (use_grad_mean), the inner update every third call."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((4, 3)).astype(np.float32),
          rng.standard_normal(5).astype(np.float32)]
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(1e-2, b1=0.9, b2=0.999, weight_decay=1e-2)), 3)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    ps = [torch.nn.Parameter(t(a)) for a in p0]
    opt = MultiSteps(AdamW([("a", ps[0]), ("b", ps[1])], lambda s: 1e-2,
                           weight_decay=1e-2, grad_clip=1.0), 3)
    for i in range(9):
        g = [rng.standard_normal(a.shape).astype(np.float32) * 3
             for a in p0]
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        emitted = opt.step([t(a) for a in g])
        assert emitted == (i % 3 == 2)
        for got, want in zip(ps, jp):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-6, rtol=0)
