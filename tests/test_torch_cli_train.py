"""The port's training CLI end to end on the CPU: a tiny debug YAML over
synthesised PNG folders (as tests/test_cli_train.py does for the JAX CLI),
a few iterations through the frozen and the released step, checkpoints in
the reference format, then auto-resume.  Imports no JAX."""

import os

import numpy as np
import pytest
import torch

from textualdegremoval_tpu_torch.cli.train_restoration import main
from textualdegremoval_tpu_torch.convert import load_reference_checkpoint
from textualdegremoval_tpu_torch.models import define_network

from torch_port_util import torch_share_of_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_share_of_cores")

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
    dino = root / "dino.pth"
    dino.write_bytes(b"")
    opt["name"], opt["path"]["pretrain_dino"] = "dino_smoke", str(dino)
    cfg3 = root / "opt_dino.yml"
    cfg3.write_text(yaml.dump(opt))
    with pytest.raises(NotImplementedError, match="A6"):
        main(["--opt", str(cfg3), "--max_iters", "1", "--device", "cpu"])


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
