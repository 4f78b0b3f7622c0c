"""PyTorch port vs JAX package: one whole training step of PromptIRRefFusion
(the network of promptir_all_in_one.yml) at small widths, f32 on the CPU.

dim 48 (the reference's prompt dims fit its layout only there) and the
shipped heads (1, 2, 4, 8): the noise block noise_level3 has C = 704 with
4 heads, 176 channels a head, the width whose float32 backward the card
runs on csrc/tblock_attn_bwd.cu.  Bounds as tests/test_torch_train.py
holds the Restormer step."""

import numpy as np
import pytest
import jax.numpy as jnp

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.losses import build_loss as j_build_loss
from textualdegremoval_tpu.models.promptir import (
    PromptIRRefFusion as JPromptIRRefFusion,
)
from textualdegremoval_tpu.train import schedules as jsched
from textualdegremoval_tpu.train.trainer import (
    build_optimizer as j_build_optimizer,
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)

from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models.layers import TransformerBlock
from textualdegremoval_tpu_torch.models.promptir import PromptIRRefFusion
from textualdegremoval_tpu_torch.train import schedules as sched
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_train_step,
)

from test_torch_train import _batch, _flat
from torch_port_util import randomize, t

SMALL_REF = dict(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                 heads=(1, 2, 4, 8), nf=48, ext_n_blocks=(1, 1, 1, 1),
                 reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)


def test_promptir_train_step_matches_jax():
    """One step: L1, the YAML's optimizer (AdamW 2e-4 / ref 1e-4 cosine,
    wd 1e-4, clip 0.01), EMA 0.9."""
    model = randomize(PromptIRRefFusion(**SMALL_REF), 1, scale=0.05)
    widths = {(m.attn.qkv.weight.shape[1], m.num_heads)
              for m in model.modules() if isinstance(m, TransformerBlock)}
    assert (704, 4) in widths  # 176 channels a head
    batch = _batch(2)
    s_lr = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 10],
            "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
    loss_opt = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}

    params = convert_state_dict(model.state_dict())
    tx = j_build_optimizer(params, jsched.build_schedule(2e-4, s_lr),
                           jsched.build_schedule(1e-4, s_lr))
    jstep = j_make_train_step(JPromptIRRefFusion(**SMALL_REF).apply,
                              j_build_loss(loss_opt), tx, ema_decay=0.9,
                              donate=False)
    jstate, jm = jstep(j_create_train_state(params, tx),
                       {k: jnp.asarray(v) for k, v in batch.items()})

    opt = build_optimizer(model, sched.build_schedule(2e-4, s_lr),
                          sched.build_schedule(1e-4, s_lr))
    step = make_train_step(build_loss(loss_opt), ema_decay=0.9)
    state, m = step(create_train_state(model, opt, ema_decay=0.9),
                    {k: t(v) for k, v in batch.items()})

    # as test_train_step_matches_jax: f32 sums in other orders
    assert float(m["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    got = convert_state_dict(state.model.state_dict())
    got_ema = convert_state_dict(state.ema_state_dict())
    for (path, g), (_, w), (_, e), (_, we) in zip(
            _flat(got), _flat(jstate.params), _flat(got_ema),
            _flat(jstate.ema_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=path)
        np.testing.assert_allclose(e, we, rtol=0, atol=2e-7, err_msg=path)
    assert state.step == 1 and int(jstate.step) == 1
