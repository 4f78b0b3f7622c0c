"""The port's training CLI end to end on the CPU: a tiny debug YAML over
synthesised PNG folders (as tests/test_cli_train.py does for the JAX CLI),
a few iterations through the frozen and the released step, checkpoints in
the reference format, then auto-resume; the DINO reference-crop matcher
from a seeded small ViT in the reference layout; and every shipped
Restormer, PromptIR, NAFNet, DRSformer and SFNet training YAML over
synthesised folders of its dataset type, its network cut to toy widths.
Imports no JAX."""

import os

import numpy as np
import pytest
import torch

import textualdegremoval_tpu_torch.cli.train_restoration as tr
from textualdegremoval_tpu_torch.cli.train_restoration import main
from textualdegremoval_tpu_torch.convert import load_reference_checkpoint
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.dino import DinoVisionTransformer

from textualdegremoval_tpu_torch.cli.evaluate import shrink_for_smoke

from torch_port_util import randomize, torch_share_of_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_share_of_cores")

OPTIONS = os.path.join(os.path.dirname(__file__), "..", "options",
                       "train_restoration")

NET = {
    "type": "RestormerRefFusion", "dim": 8, "num_blocks": [1, 1, 1, 1],
    "num_refinement_blocks": 1, "heads": [1, 1, 2, 2],
    "ffn_expansion_factor": 2.66, "bias": False, "LayerNorm_type": "WithBias",
    "nf": 8, "ext_n_blocks": [1, 1, 1, 1], "reffusion_n_blocks": [1, 1, 1, 1],
    "lr_block_size": 4,
}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import cv2
    import yaml

    root = tmp_path_factory.mktemp("torch_train_ws")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for sub in ("lq", "hq", "ref"):
            (root / split / sub).mkdir(parents=True)
        for i in range(4 if split == "train" else 1):
            img = (rng.random((40, 44, 3)) * 255).astype(np.uint8)
            for sub in ("lq", "hq", "ref"):
                cv2.imwrite(str(root / split / sub / f"img_{i:02d}.png"), img)

    def folders(split):
        return {"lqroot": str(root / split / "lq"),
                "hqroot": str(root / split / "hq"),
                "refroot": str(root / split / "ref")}

    opt = {
        "name": "debug_torch_smoke", "model_type": "RefGuidedImageCleanModel",
        "scale": 1, "manual_seed": 7,
        "datasets": {
            "train": {
                "name": "T", "type": "Dataset_PairedImageWithRef",
                **folders("train"), "geometric_augs": True,
                "io_backend": {"type": "disk"}, "num_worker_per_gpu": 0,
                "batch_size_per_gpu": 2, "mini_batch_sizes": [2],
                "iters": [1000], "gt_size": 32, "gt_sizes": [32]},
            "val": {"name": "V", "type": "Dataset_PairedImageWithRef",
                    **folders("val"), "io_backend": {"type": "disk"}},
        },
        "network_g": NET,
        "path": {"pretrain_dino": None, "pretrain_network_g": None,
                 "resume_state": None},
        "train": {
            "total_iter": 4, "warmup_iter": -1, "use_grad_clip": True,
            "param_fix_iterations": 2, "ema_decay": 0.9,
            "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                          "periods": [2, 2], "restart_weights": [1, 1],
                          "eta_mins": [0.0003, 0.000001]},
            "optim_g": {"type": "AdamW", "lr": 2.0e-4, "ref_lr": 1.0e-4,
                        "weight_decay": 1.0e-4, "betas": [0.9, 0.999]},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1,
                          "reduction": "mean"},
            "mixing_augs": {"mixup": True, "mixup_beta": 1.2,
                            "use_identity": True},
        },
        "val": {"val_freq": 100, "max_minibatch": 1, "window_size": 8},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 100},
    }
    cfg = root / "opt.yml"
    cfg.write_text(yaml.dump(opt))
    return root, str(cfg)


def test_few_steps_checkpoint_and_resume(workspace, monkeypatch):
    root, cfg = workspace
    monkeypatch.chdir(root)
    state = main(["--opt", cfg, "--max_iters", "3", "--device", "cpu"])
    assert state.step == 3 and state.opt.count == 3
    exp = root / "experiments" / "debug_torch_smoke"
    # the debug name saves every 8 iterations; the end of the run saves too
    assert (exp / "training_states" / "state_3.pth").exists()
    net = exp / "models" / "net_g_3.pth"
    for key in ("params", "params_ema"):
        m = load_reference_checkpoint(define_network(NET), str(net), key=key)
        assert all(torch.isfinite(p).all() for p in m.parameters())
    assert (exp / "train.log").read_text().count("l_pix") == 3

    # auto-resume: continues from iteration 3 to 5
    state = main(["--opt", cfg, "--max_iters", "5", "--device", "cpu"])
    assert state.step == 5 and state.opt.count == 5
    assert os.path.exists(exp / "training_states" / "state_5.pth")


def test_validation_and_refusals(workspace, monkeypatch):
    import yaml

    from textualdegremoval_tpu_torch.cli.train_restoration import (
        resolve_network,
    )

    root, cfg = workspace
    monkeypatch.chdir(root)
    opt = yaml.safe_load(open(cfg))
    opt["name"], opt["val"]["val_freq"] = "val_smoke", 1
    cfg2 = root / "opt_val.yml"
    cfg2.write_text(yaml.dump(opt))
    state = main(["--opt", str(cfg2), "--max_iters", "1", "--device", "cpu",
                  "--mixed_precision", "bf16", "--remat"])
    assert state.step == 1
    log = (root / "experiments" / "val_smoke" / "train.log").read_text()
    assert "val @ 1: psnr" in log and "bfloat16" in log

    # fused_kernels off builds module-path blocks, a route on every device
    from textualdegremoval_tpu_torch.models.layers import TransformerBlock

    model, _, _ = resolve_network({**opt, "train": {**opt["train"],
                                                    "fused_kernels": "off"}})
    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)]
    assert blocks and not any(b.fused for b in blocks)
    with pytest.raises(ValueError, match="forward only"):
        resolve_network({**opt, "network_g": {**opt["network_g"],
                                              "fused": False,
                                              "mdta_pallas": True}})
    # a DINO file: the matcher picks each step's reference window
    opt["name"], opt["path"]["pretrain_dino"] = "dino_smoke", tiny_dino(root)
    cfg3 = root / "opt_dino.yml"
    cfg3.write_text(yaml.dump(opt))
    calls = []

    def counted(dino, lq, ref, **kw):
        calls.append((tuple(lq.shape), tuple(ref.shape)))
        return real(dino, lq, ref, **kw)

    real = tr.select_ref_crop
    monkeypatch.setattr(tr, "select_ref_crop", counted)
    state = main(["--opt", str(cfg3), "--max_iters", "1", "--device", "cpu"])
    assert state.step == 1
    assert calls == [((2, 32, 32, 3), (2, 40, 44, 3))]
    log = (root / "experiments" / "dino_smoke" / "train.log").read_text()
    assert "DINO matcher loaded" in log and log.count("l_pix") == 1


def tiny_dino(root) -> str:
    """A seeded DINO ViT of small width (64 channels, one block, a 2 x 2
    position grid) saved as a reference-layout state dict; its path."""
    path = root / "dino_tiny.pth"
    if not path.exists():
        vit = randomize(DinoVisionTransformer(img_size=28, embed_dim=64,
                                              depth=1, num_heads=1), 3)
        torch.save(vit.state_dict(), path)
    return str(path)


def test_nafnet_motion_deblur_yaml_trains(workspace, monkeypatch):
    """options/train_restoration/nafnet_motion_deblur.yml as it is, with its
    network cut to toy widths (the evaluation CLI's --tiny_debug rule) and
    its data pointed at the synthesised folders: NAFNetRefFusion through
    resolve_network, the masa/trunk split of every masa_* parameter, the
    PSNR loss, a frozen and a released step."""
    import yaml

    from textualdegremoval_tpu_torch.cli.evaluate import shrink_for_smoke

    root, cfg = workspace
    monkeypatch.chdir(root)
    base = yaml.safe_load(open(cfg))
    opt = yaml.safe_load(open(os.path.join(
        os.path.dirname(__file__), "..", "options", "train_restoration",
        "nafnet_motion_deblur.yml")))
    opt["datasets"] = base["datasets"]
    opt["network_g"] = shrink_for_smoke(opt["network_g"])
    opt["path"]["pretrain_dino"] = None
    opt["train"]["param_fix_iterations"] = 1
    opt["logger"]["print_freq"] = 1
    cfg2 = root / "opt_nafnet.yml"
    cfg2.write_text(yaml.dump(opt))
    state = main(["--opt", str(cfg2), "--max_iters", "2", "--device", "cpu"])
    assert state.step == 2 and state.opt.count == 2
    assert type(state.model).__name__ == "NAFNetRefFusion"
    masa = {n.split(".")[0] for n, m in zip(state.opt.names, state.opt.masa)
            if m}
    assert masa == {"masa_enc", "masa_blk_enc", "masa_blk_middle"}
    log = (root / "experiments" / "nafnet_motion_deblur" /
           "train.log").read_text()
    assert log.count("l_pix") == 2


def test_loader_workers_draw_their_own_crops(tmp_path):
    """Two spawned workers each reseed the dataset's augmentation RNG: over
    four copies of one image, without the reseed each worker's first crop
    would be the same."""
    import cv2

    from textualdegremoval_tpu_torch.data.loader import (
        create_dataloader, create_dataset,
    )

    img = (np.random.default_rng(1).random((40, 44, 3)) * 255).astype(
        np.uint8)
    for sub in ("lq", "hq", "ref"):
        (tmp_path / sub).mkdir()
        for i in range(4):
            cv2.imwrite(str(tmp_path / sub / f"img_{i}.png"), img)
    opt = {"type": "Dataset_PairedImageWithRef", "phase": "train",
           "lqroot": str(tmp_path / "lq"), "hqroot": str(tmp_path / "hq"),
           "refroot": str(tmp_path / "ref"), "gt_size": 16,
           "batch_size_per_gpu": 1, "num_worker_per_gpu": 2}
    loader = create_dataloader(create_dataset(opt), opt)
    torch.manual_seed(0)  # the workers' base seed
    batches = list(loader)
    assert len(batches) == 4
    assert all(b["lq"].shape == (1, 16, 16, 3) for b in batches)
    assert len({b["gt"].numpy().tobytes() for b in batches}) == 4


@pytest.fixture(scope="module")
def dataset_folders(tmp_path_factory):
    """Synthesised folders for the denoise, dual-pixel (16-bit lqL, lqR and
    gt, 8-bit ref) and all-in-one (denoise, derain, dehaze) datasets."""
    import cv2

    root = tmp_path_factory.mktemp("yaml_data")
    rng = np.random.default_rng(1)
    subs = {"denoise": ("hq", "ref"), "derain": ("lq", "hq", "ref"),
            "dehaze": ("lq", "hq", "ref"), "val": ("lq", "hq", "ref"),
            "dp": ("gt", "lqL", "lqR", "ref")}
    for task, names in subs.items():
        for sub in names:
            (root / task / sub).mkdir(parents=True)
            for i in range(2):
                top = 65535 if task == "dp" and sub != "ref" else 255
                img = (rng.random((40, 44, 3)) * top).astype(
                    np.uint16 if top > 255 else np.uint8)
                cv2.imwrite(str(root / task / sub / f"img_{i}.png"), img)
    # the dehaze YAMLs' meta_info file: 'hazy_name gt_name' lines
    (root / "dehaze" / "meta_info.txt").write_text(
        "img_0.png img_1.png\nimg_1.png img_0.png\n")
    return root


GAUSSIAN_YAMLS = [f"restormer_gaussian_{c}_denoise_{s}.yml"
                  for c in ("color", "gray") for s in ("15", "25", "50",
                                                       "blind")]


def _point_at(ds: dict, root) -> dict:
    """A YAML dataset section with its folders replaced by synthesised
    ones of its type."""
    ds = dict(ds)
    kind = ds["type"]
    if kind == "Dataset_GaussianDenoisingWithRef":
        ds.update(hqroot=str(root / "denoise" / "hq"),
                  refroot=str(root / "denoise" / "ref"))
    elif kind == "Dataset_PairedImageWithRef_DualPixel_16bit":
        ds.update({k: str(root / "dp" / s) for k, s in (
            ("hqroot", "gt"), ("lqlroot", "lqL"), ("lqrroot", "lqR"),
            ("refroot", "ref"))})
    elif kind == "Dataset_PairedDehazeWithRef":
        ds.update({f"{s}root": str(root / "dehaze" / s)
                   for s in ("lq", "hq", "ref")},
                  meta_info_file=str(root / "dehaze" / "meta_info.txt"))
    elif kind == "Dataset_PairedUnifiedWithRef":
        for task in ("denoise", "derain", "dehaze"):
            ds[task] = {f"{s}root": str(root / task / s)
                        for s in ("lq", "hq", "ref")
                        if (root / task / s).exists()}
    else:
        ds.update({f"{s}root": str(root / "val" / s)
                   for s in ("lq", "hq", "ref")})
    return ds


DRSFORMER_YAMLS = [f"drsformer_derain_{d}.yml"
                   for d in ("rain200h", "rain200l", "did", "dnd", "spa")]
SFNET_YAMLS = ["sfnet_dehaze_indoor.yml", "sfnet_dehaze_outdoor.yml"]


@pytest.mark.parametrize("name", GAUSSIAN_YAMLS + [
    "restormer_defocus_dual_pixel_16bit.yml", "promptir_all_in_one.yml"]
    + DRSFORMER_YAMLS + SFNET_YAMLS)
def test_shipped_yaml_trains(workspace, dataset_folders, monkeypatch, name):
    """Each shipped Restormer / PromptIR / DRSformer / SFNet YAML as it is,
    its data pointed at synthesised folders of its dataset types (the
    dehaze ones through their meta_info file), its network cut to toy
    widths, batch 2 of 32 px: two iterations through the CLI (a frozen and
    a released step), the lq|gt|pred|ref strip of logger.check_freq.  With
    a DINO file, the 3-channel networks pick their references with the
    matcher and the 1- (gray) and 6-channel (dual-pixel) ones are refused
    before the first step.  The DRSformer and SFNet YAMLs validate at the
    second iteration too (SFNet's finest scale scored, its BN statistics
    in eval mode), and SFNet's steps move its BN running statistics."""
    import yaml

    root, _ = workspace
    monkeypatch.chdir(root)
    opt = yaml.safe_load(open(os.path.join(OPTIONS, name)))
    for phase in ("train", "val"):
        opt["datasets"][phase] = _point_at(opt["datasets"][phase],
                                           dataset_folders)
    opt["datasets"]["train"].update(
        num_worker_per_gpu=0, batch_size_per_gpu=2, mini_batch_sizes=[2],
        gt_size=32, gt_sizes=[32])
    opt["network_g"] = shrink_for_smoke(opt["network_g"])
    opt["train"]["param_fix_iterations"] = 1
    opt["logger"].update(print_freq=1, check_freq=2)
    new_family = name in DRSFORMER_YAMLS + SFNET_YAMLS
    if new_family:
        opt["val"].update(val_freq=2, max_minibatch=1)
    opt["path"]["pretrain_dino"] = tiny_dino(root)
    cfg = root / f"opt_{name}"
    cfg.write_text(yaml.dump(opt))
    calls = []
    real = tr.select_ref_crop
    monkeypatch.setattr(tr, "select_ref_crop",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    in_ch = opt["network_g"].get("inp_channels", 3)
    if in_ch != 3:
        with pytest.raises(ValueError, match=f"{in_ch}-channel"):
            main(["--opt", str(cfg), "--max_iters", "2", "--device", "cpu"])
        exp = root / "experiments" / opt["name"]
        assert "l_pix" not in (exp / "train.log").read_text()
        opt["path"]["pretrain_dino"] = None
        cfg.write_text(yaml.dump(opt))
    state = main(["--opt", str(cfg), "--max_iters", "2", "--device", "cpu"])
    assert state.step == 2 and len(calls) == (2 if in_ch == 3 else 0)
    exp = root / "experiments" / opt["name"]
    log = (exp / "train.log").read_text()
    assert log.count("l_pix") == 2
    assert ("val @ 2: psnr" in log) == new_family
    assert type(state.model).__name__ == opt["network_g"]["type"]
    if name in SFNET_YAMLS:
        bn = state.model.Encoder[0].layers[0].dyna.bn
        assert int(bn.num_batches_tracked) == 2
        assert not torch.equal(bn.running_var, torch.ones_like(
            bn.running_var))
    import cv2

    strip = cv2.imread(str(exp / "visualization" / "000002.png"),
                       cv2.IMREAD_UNCHANGED)
    assert strip.shape[:2] == (32, 4 * 32)


def test_chip_smoke_options_are_the_shipped_yamls():
    """chip_smoke.py carries its training options as dicts (the card's
    machine may lack PyYAML): they are the shipped YAMLs' networks and
    train sections, param_fix_iterations aside."""
    import yaml

    import chip_smoke

    def load(name):
        return yaml.safe_load(open(os.path.join(OPTIONS, f"{name}.yml")))

    for name, opt in (("restormer_motion_deblur", chip_smoke.TRAIN_OPT),
                      ("promptir_all_in_one", chip_smoke.PROMPTIR_TRAIN_OPT),
                      ("drsformer_derain_rain200h", chip_smoke.DRS_TRAIN_OPT),
                      ("sfnet_dehaze_indoor", chip_smoke.SFNET_TRAIN_OPT)):
        y = load(name)
        assert opt["network_g"] == y["network_g"], name
        assert dict(opt["train"], param_fix_iterations=y["train"][
            "param_fix_iterations"]) == y["train"], name
    for name, over in chip_smoke.CLI_YAML_NETS.items():
        assert dict(chip_smoke.TRAIN_OPT["network_g"], **over) == \
            load(name)["network_g"], name
