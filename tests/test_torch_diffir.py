"""PyTorch port vs JAX package: the DiffIR path (train/diffir_trainer.py,
cli/train_diffir.py, train/model_registry.py, utils/logger.py).

Small towers as tests/test_diffir_trainer.py builds them (a 1-layer,
32-wide CLIP vision tower at 224 px, so that the CLIP view is the real
one; a 2-word I2T mapper), seeded weights carried to JAX by the JAX
package's converters.  Bounds: the CLIP view and the embedding as their
tests say (C3's resize difference); the step's loss to 1e-6 relative,
each gradient to 1e-4 of its norm in L2 plus 1e-5 of the global norm,
the update (C3)
within 2e-6 at every element where the gradient is far above Adam's eps
and 0.5 lr everywhere.  Also the CLI on the CPU with auto-resume, both
registry model types, the JAX CLI's tower loading (C12), and the
logger's line and scalars.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from textualdegremoval_tpu.cli import train_diffir as j_cli
from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.losses import build_loss as j_build_loss
from textualdegremoval_tpu.models.clip import CLIPVisionEncoder as JCLIP
from textualdegremoval_tpu.models.mappers import I2TMapper as JMapper
from textualdegremoval_tpu.models.nafnet_dynamic import (
    NAFNetDynamicFusion as JNet,
)
from textualdegremoval_tpu.train.diffir_trainer import (
    make_diffir_train_step as j_make_diffir_train_step,
    make_embed_fn as j_make_embed_fn,
)
from textualdegremoval_tpu.train.trainer import (
    build_optimizer as j_build_optimizer,
    create_train_state as j_create_train_state,
)
from textualdegremoval_tpu.utils import logger as j_logger

from textualdegremoval_tpu_torch.cli import train_diffir as cli
from textualdegremoval_tpu_torch.convert import (
    load_reference_checkpoint, mapper_reference_state_dict,
)
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.clip import CLIPVisionEncoder
from textualdegremoval_tpu_torch.models.mappers import I2TMapper
from textualdegremoval_tpu_torch.models.nafnet_dynamic import (
    NAFNetDynamicFusion,
)
from textualdegremoval_tpu_torch.ops.resize import bilinear_resize_torch
from textualdegremoval_tpu_torch.train.diffir_trainer import (
    make_diffir_train_step, make_embed_fn,
)
from textualdegremoval_tpu_torch.train.model_registry import create_model
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state,
)
from textualdegremoval_tpu_torch.utils import logger as p_logger

from torch_port_util import jax_tower_tree, randn, randomize, t

CLIP = dict(image_size=224, patch_size=14, width=32, layers=1, heads=2)
MAPPER = dict(num_words=2, input_dim=32, output_dim=1024)
NET = dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1),
           dec_blk_nums=(1, 1))


def towers(seed=0):
    """The port's small towers, seeded at a working scale, in eval mode."""
    enc = randomize(CLIPVisionEncoder(**CLIP), seed, scale=0.05)
    mapper = randomize(I2TMapper(**MAPPER), seed + 1, scale=0.05)
    return enc.eval(), mapper.eval()


def assert_within(got, want, frac=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _exact_view(lq):
    """JAX's bilinear weight matrices (`compute_weight_mat`, what
    jax.image.resize applies) in float64, then the CLIP normalisation."""
    from jax._src.image import scale as jscale

    v = lq.astype(np.float64)
    for d in (1, 2):
        if v.shape[d] != 224:
            w = np.asarray(jscale.compute_weight_mat(
                v.shape[d], 224, 224 / v.shape[d], 0.0,
                jscale._fill_triangle_kernel, True), np.float64)
            v = np.moveaxis(np.tensordot(v, w, axes=([d], [0])), -1, d)
    return (v - np.asarray(j_cli.CLIP_MEAN)) / np.asarray(j_cli.CLIP_STD)


@pytest.mark.parametrize("hw", [64, 300])
def test_clip_view_is_jax_antialiased_bilinear(hw):
    """The 224 px view of a 64 px lq (upscale) and of a 300 px one
    (downscale, where jax.image.resize antialiases) within 4e-6 of JAX's
    weights applied in float64 (1e-6 before the division by CLIP's std;
    C3: XLA's float32 einsum on the CPU strays some 2e-5 from exact sums,
    so JAX's own view is held at 2e-4); at 300 px F.interpolate's
    bilinear, which does not antialias, is far from it."""
    lq = np.random.default_rng(hw).random((2, hw, hw + 8, 3),
                                          dtype=np.float32)
    got = cli.clip_view(t(lq), 224).numpy()
    exact = _exact_view(lq)
    np.testing.assert_allclose(got, exact, rtol=0, atol=4e-6)
    mean, std = np.asarray(j_cli.CLIP_MEAN), np.asarray(j_cli.CLIP_STD)
    jax_view = (jax.image.resize(lq, (2, 224, 224, 3), "bilinear")
                - mean) / std
    np.testing.assert_allclose(got, jax_view, rtol=0, atol=2e-4)
    plain = (bilinear_resize_torch(t(lq), 224, 224).numpy() - mean) / std
    far = np.abs(plain - exact).max()
    assert (far > 0.05) if hw > 224 else (far < 1e-4)


def test_embedding_matches_jax_embed_fn():
    """`make_embed_fn` (the frozen towers) against JAX's on one view, to
    1e-5 of the largest value; `make_device_embed_fn` (view, towers) for a
    64 px and a 300 px lq to 1e-4 of it, the view's C3 difference carried
    through the towers.  The towers end frozen."""
    enc, mapper = towers()
    jparams = (jax_tower_tree(enc, "image_encoder"),
               jax_tower_tree(mapper, "mapper"))
    view = randn(np.random.default_rng(2), 2, 224, 224, 3)
    want = j_make_embed_fn(JCLIP(**CLIP).apply, JMapper(**MAPPER).apply,
                           *jparams)(jnp.asarray(view))
    got = make_embed_fn(enc, mapper)(t(view))
    assert got.shape == (2, MAPPER["num_words"], 1024)
    assert not got.requires_grad
    assert not any(p.requires_grad for m in (enc, mapper)
                   for p in m.parameters())
    assert_within(got, want)
    jfn = j_cli.make_device_embed_fn(JCLIP(**CLIP), JMapper(**MAPPER),
                                     *jparams)
    for hw in (64, 300):
        lq = np.random.default_rng(hw).random((2, hw, 260, 3),
                                              dtype=np.float32)
        assert_within(cli.make_device_embed_fn(enc, mapper)(t(lq)),
                      jfn(jnp.asarray(lq)), 1e-4)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(tree[k])


def test_train_step_matches_jax():
    """One DiffIR step (L1, AdamW 1e-3 constant, wd 1e-4, clip 0.01, EMA
    0.9) against JAX's `make_diffir_train_step`; JAX's raw gradients kept
    by a transform chained ahead of its optimizer (a pass-through whose
    state is the gradient)."""
    model = randomize(NAFNetDynamicFusion(**NET, num_words=2), 11, 0.05)
    rng = np.random.default_rng(12)
    batch = {"lq": rng.random((2, 16, 16, 3), np.float32),
             "gt": rng.random((2, 16, 16, 3), np.float32),
             "embed": randn(rng, 2, 2, 1024, scale=0.2)}
    lr, loss_opt = 1e-3, {"type": "L1Loss", "loss_weight": 1}

    params = convert_state_dict(model.state_dict())
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, j_build_optimizer(params, lambda s: lr,
                                             grad_clip=0.01))
    jstate, jm = jax.jit(j_make_diffir_train_step(
        JNet(**NET).apply, j_build_loss(loss_opt), tx, ema_decay=0.9))(
        j_create_train_state(params, tx),
        {k: jnp.asarray(v) for k, v in batch.items()})

    opt = build_optimizer(model, lambda s: lr, grad_clip=0.01)
    state = create_train_state(model, opt, ema_decay=0.9)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {}
    update = state.opt.step
    state.opt.step = lambda gs: (grads.update(zip(state.opt.names, gs)),
                                 update(gs))
    state, m = make_diffir_train_step(build_loss(loss_opt), 0.9)(
        state, {k: t(v) for k, v in batch.items()})
    del state.opt.step

    assert float(m["l_pix"]) == pytest.approx(float(jm["l_pix"]), rel=1e-6)
    total = float(jm["grad_norm"])
    jgrads = dict(_leaves(jstate.opt_state[0]))
    for path, g in _leaves(convert_state_dict(grads)):
        w = jgrads[path]
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) \
            + 1e-5 * total, path
    # C3: Adam's first update is about lr * sign(g); where |g| is near eps
    # a rounding difference moves it by up to 0.5 lr
    after = dict(_leaves(convert_state_dict(state.model.state_dict())))
    start = dict(_leaves(convert_state_dict(before)))
    for path, w in _leaves(jstate.params):
        d = np.abs((after[path] - start[path]) - (w - start[path]))
        clipped = jgrads[path] * min(1.0, 0.01 / total)
        sat = np.abs(clipped) > 1e-6
        assert d.max() <= 0.5 * lr and (d[sat].max(initial=0) <= 2e-6), path
    ema = dict(_leaves(convert_state_dict(state.ema_state_dict())))
    for path, w in _leaves(jstate.ema_params):
        np.testing.assert_allclose(ema[path], w, rtol=0, atol=2e-7,
                                   err_msg=path)


def _diffir_opt(root, name, **train):
    folders = {"lqroot": str(root / "lq"), "hqroot": str(root / "hq")}
    return {
        "name": name, "model_type": "DiffIRRefGuidedImageCleanModel",
        "scale": 1, "manual_seed": 3,
        "datasets": {"train": {
            "name": "T", "type": "Dataset_PairedImage", **folders,
            "io_backend": {"type": "disk"}, "num_worker_per_gpu": 0,
            "batch_size_per_gpu": 2, "gt_size": 32, "geometric_augs": True}},
        "network_g": {"type": "NAFNetDynamicFusion",
                      **{k: list(v) if isinstance(v, tuple) else v
                         for k, v in NET.items()}},
        "network_clip": dict(CLIP, image_size=28),
        "network_mapper": MAPPER,
        "path": {},
        "train": {"total_iter": 2, "warmup_iter": 1, "use_grad_clip": True,
                  "ema_decay": 0.9,
                  "scheduler": {"type": "MultiStepRestartLR",
                                "milestones": [100], "gamma": 0.5},
                  "optim_g": {"type": "AdamW", "lr": 1e-3},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1},
                  **train},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 100}}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from textualdegremoval_tpu_torch.data.png import write_png

    root = tmp_path_factory.mktemp("diffir_ws")
    rng = np.random.default_rng(0)
    for sub in ("lq", "hq", "ref"):
        (root / sub).mkdir()
    for i in range(4):
        img = (rng.random((40, 44, 3)) * 255).astype(np.uint8)
        for sub in ("lq", "hq", "ref"):
            write_png(str(root / sub / f"img_{i:02d}.png"), img)
    return root


def test_cli_trains_checkpoints_and_resumes(workspace, monkeypatch):
    """train_diffir.main on the CPU: two iterations, a log line and a
    scalars.jsonl line each, the reference-format net_g checkpoint; then
    auto-resume from iteration 2 to 3.  The towers stay as seeded."""
    monkeypatch.chdir(workspace)
    cfg = workspace / "diffir.json"
    cfg.write_text(json.dumps(_diffir_opt(workspace, "diffir_smoke")))
    state = cli.main(["--opt", str(cfg), "--max_iters", "2",
                      "--device", "cpu"])
    assert state.step == 2 and state.opt.count == 2
    exp = workspace / "experiments" / "diffir_smoke"
    lines = (exp / "train.log").read_text().splitlines()
    assert sum("l_pix: " in line for line in lines) == 2
    scalars = [json.loads(x) for x in
               (exp / "scalars.jsonl").read_text().splitlines()]
    assert [s["step"] for s in scalars] == [1, 2]
    assert all(np.isfinite(s["l_pix"]) for s in scalars)
    net = define_network({"type": "NAFNetDynamicFusion", "num_words": 2,
                          **{k: list(v) if isinstance(v, tuple) else v
                             for k, v in NET.items()}})
    for key in ("params", "params_ema"):
        load_reference_checkpoint(net, str(exp / "models" / "net_g_2.pth"),
                                  key=key)
    state = cli.main(["--opt", str(cfg), "--max_iters", "3",
                      "--device", "cpu"])
    assert state.step == 3 and state.opt.count == 3
    assert (exp / "training_states" / "state_3.pth").exists()


def test_cli_loads_towers_strictly_and_checks_word_counts(workspace,
                                                          monkeypatch):
    """path.pretrain_clip_vision (an HF CLIPVisionModel state dict, with
    the post_layernorm the tower does not use) and path.pretrain_mapper
    (the reference's per-word artifact) load strictly; a network_g whose
    num_words disagrees with the mapper's raises."""
    monkeypatch.chdir(workspace)
    enc, mapper = towers(5)
    sd = dict(enc.state_dict())  # the port's keys are HF's
    sd["vision_model.post_layernorm.weight"] = torch.ones(CLIP["width"])
    torch.save(sd, workspace / "clip.pt")
    torch.save(mapper_reference_state_dict(mapper), workspace / "mapper.pt")
    opt = _diffir_opt(workspace, "diffir_towers")
    opt["network_clip"] = CLIP
    opt["path"] = {"pretrain_clip_vision": str(workspace / "clip.pt"),
                   "pretrain_mapper": str(workspace / "mapper.pt")}
    got_enc, got_mapper = cli.build_towers(opt, "cpu")
    for a, b in ((got_enc, enc), (got_mapper, mapper)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    with pytest.raises(ValueError, match="num_words is 3"):
        cli.build_net({**opt, "network_g": {**opt["network_g"],
                                            "num_words": 3}}, 2)


def test_c12_jax_cli_tower_files_do_not_convert():
    """ROADMAP C12: JAX's DiffIR CLI loads both tower files through the
    restoration converter `load_torch_checkpoint`, whose tree does not
    have the paths of its CLIPVisionEncoder (nor of the I2T mapper, whose
    per-word keys it leaves unfolded); the port loads them with
    `load_reference_tower`, strictly (test above)."""
    from textualdegremoval_tpu.convert.tower_maps import convert_clip_vision

    enc, mapper = towers(6)
    sd = enc.state_dict()
    got = {p for p, _ in _leaves(convert_state_dict(sd))}
    want = {p for p, _ in _leaves(convert_clip_vision(sd))}
    assert got.isdisjoint(want) and want
    mgot = {p for p, _ in _leaves(convert_state_dict(
        mapper_reference_state_dict(mapper)))}
    assert not {p.split("/")[0] for p in mgot} & {"mapping", "mapping_patch"}


def test_create_model_runs_both_model_types(workspace, monkeypatch):
    """create_model's two training flows, one iteration each on the CPU
    through their CLIs."""
    monkeypatch.chdir(workspace)
    opt = _diffir_opt(workspace, "diffir_registry")
    assert create_model(opt)(max_iters=1, device="cpu").step == 1
    ref = _diffir_opt(workspace, "restoration_registry",
                      param_fix_iterations=0)
    ref.update(model_type="RefGuidedImageCleanModel", network_g={
        "type": "NAFNetRefFusion", "width": 8, "enc_blk_nums": [1, 1],
        "dec_blk_nums": [1, 1], "nf": 8, "ext_n_blocks": [1, 1],
        "reffusion_n_blocks": [1, 1], "lr_block_size": 4})
    ref["datasets"]["train"].update(type="Dataset_PairedImageWithRef",
                                    refroot=str(workspace / "ref"))
    assert create_model(ref)(max_iters=1, device="cpu").step == 1
    with pytest.raises(KeyError, match="unknown model_type"):
        create_model({"model_type": "Nothing"})


def test_message_logger_line_and_scalars_match_jax(tmp_path, monkeypatch,
                                                   caplog):
    """The same iteration through both MessageLoggers, the clock fixed:
    the same line; the port's ScalarWriter writes the step's JSONL line."""
    for mod in (j_logger, p_logger):
        monkeypatch.setattr(mod.time, "time", lambda: 1000.0)
    args = (3, 1234, [2e-4, 1e-4], {"l_pix": 0.25, "grad_norm": 1.5}, 0.5,
            0.125)
    lines = []
    for mod, name in ((j_logger, "tdr_jax_test"), (p_logger, "tdr_test")):
        log = logging.getLogger(name)
        log.handlers, log.propagate = [], True
        msg = mod.MessageLogger(5000, 1000, None, log)
        msg.start_time = 1000.0 - 117.0
        with caplog.at_level(logging.INFO, logger=name):
            msg(*args)
        lines.append(caplog.records[-1].getMessage())
    assert lines[0] == lines[1]
    writer = p_logger.ScalarWriter(str(tmp_path))
    p_logger.MessageLogger(5000, 1000, writer,
                           p_logger.get_root_logger("tdr_w"))(*args)
    writer.close()
    assert json.loads((tmp_path / "scalars.jsonl").read_text()) == {
        "step": 1234, "l_pix": 0.25, "grad_norm": 1.5}


def test_scalar_writer_mirrors_to_tensorboard_and_wandb(tmp_path,
                                                        monkeypatch):
    """With use_tb_logger and a wandb project the scalars also go to
    TensorBoard's SummaryWriter and wandb.log (stub modules here, so no
    package is needed); the JSONL line is written either way."""
    import sys
    import types

    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("tb_init", log_dir))

        def add_scalar(self, k, v, step):
            calls.append(("tb", k, v, step))

        def close(self):
            calls.append(("tb_close",))

    wandb = types.SimpleNamespace(
        init=lambda **kw: calls.append(("wandb_init", kw["project"])),
        log=lambda values, step: calls.append(("wandb", values, step)))
    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    writer = p_logger.ScalarWriter(str(tmp_path), {"project": "p"},
                                   tensorboard=True)
    writer.write(7, {"l_pix": 0.5})
    writer.close()
    assert calls == [("tb_init", str(tmp_path)), ("wandb_init", "p"),
                     ("tb", "l_pix", 0.5, 7), ("wandb", {"l_pix": 0.5}, 7),
                     ("tb_close",)]
    assert json.loads((tmp_path / "scalars.jsonl").read_text()) == {
        "step": 7, "l_pix": 0.5}
