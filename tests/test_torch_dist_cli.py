"""The port's training CLIs as two gloo ranks on the CPU, each a process of
tests/torch_dist_worker.py under the torch launcher's env (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) on a free local port,
retried on the environmental failures that tests/test_bootstrap.py
retries: rank 0 alone writes the log, the scalars and the checkpoints,
both ranks end with one model, and a later single process auto-resumes
from what they wrote.  The four-rank CLI against one process follows
tests/test_multihost.py and is marked slow, as that file is."""

import json

import numpy as np
import pytest
import torch

from textualdegremoval_tpu_torch.data.png import write_png

import torch_dist_worker as dw

NET = {
    "type": "RestormerRefFusion", "dim": 8, "num_blocks": [1, 1, 1, 1],
    "num_refinement_blocks": 1, "heads": [1, 1, 2, 2],
    "ffn_expansion_factor": 2.66, "bias": False, "LayerNorm_type": "WithBias",
    "nf": 8, "ext_n_blocks": [1, 1, 1, 1], "reffusion_n_blocks": [1, 1, 1, 1],
    "lr_block_size": 4,
}


def _pngs(root, n, hw=(40, 44), same=False, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    for sub in ("lq", "hq", "ref"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        if not same:
            img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        for sub in ("lq", "hq", "ref"):
            write_png(str(root / sub / f"img_{i:02d}.png"), img)
    return {s: str(root / s) for s in ("lq", "hq", "ref")}


def _restoration_opt(root, name, batch, gt_size=32, val=True,
                     hw=(40, 44), **train):
    d = _pngs(root / "train", 4, hw=hw, same=not val)
    datasets = {"train": {
        "name": "T", "type": "Dataset_PairedImageWithRef",
        "lqroot": d["lq"], "hqroot": d["hq"], "refroot": d["ref"],
        "geometric_augs": False, "io_backend": {"type": "disk"},
        "num_worker_per_gpu": 0, "batch_size_per_gpu": batch,
        "mini_batch_sizes": [batch], "iters": [1000], "gt_size": gt_size,
        "gt_sizes": [gt_size]}}
    if val:
        v = _pngs(root / "val", 1, seed=1)
        datasets["val"] = {"name": "V", "type": "Dataset_PairedImageWithRef",
                           "lqroot": v["lq"], "hqroot": v["hq"],
                           "refroot": v["ref"], "io_backend": {"type": "disk"}}
    return {
        "name": name, "model_type": "RefGuidedImageCleanModel", "scale": 1,
        "manual_seed": 7, "datasets": datasets, "network_g": NET,
        "path": {"pretrain_dino": None, "pretrain_network_g": None},
        "train": {
            "total_iter": 100, "warmup_iter": -1, "use_grad_clip": True,
            "ema_decay": 0.9,
            "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                          "periods": [50, 50], "restart_weights": [1, 1],
                          "eta_mins": [0.0003, 0.000001]},
            "optim_g": {"type": "AdamW", "lr": 2.0e-4, "ref_lr": 1.0e-4},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1,
                          "reduction": "mean"}, **train},
        "val": {"val_freq": 2, "max_minibatch": 1, "window_size": 8},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2,
                   "check_freq": 1},
    }


def _run(work, case, argv, world):
    torch.save({"argv": argv}, work / "input.pt")
    return dw.spawn(case, work, world)


def test_restoration_cli_two_ranks_rank0_io_and_resume(tmp_path):
    cfg = tmp_path / "opt.json"
    # the first iteration with the masa group frozen: its step reduces the
    # live gradients only
    cfg.write_text(json.dumps(_restoration_opt(tmp_path, "dist_cli", 1,
                                               param_fix_iterations=2)))
    argv = ["--opt", str(cfg), "--device", "cpu", "--max_iters", "2"]
    ranks = _run(tmp_path, "cli_restoration", argv, 2)
    exp = tmp_path / "experiments" / "dist_cli"
    log = (exp / "train.log").read_text()
    # rank 0's lines alone: two iterations, one validation, no rank 1
    assert log.count("l_pix") == 2 and log.count("val @ 2") == 1
    assert "rank 0 of 2" in log and "rank 1 of 2" not in log
    assert sorted(p.name for p in (exp / "models").iterdir()) == [
        "net_g_2.pth"]
    assert sorted(p.name for p in (exp / "training_states").iterdir()) == [
        "state_2.pth"]
    assert len(list((exp / "visualization").iterdir())) == 2
    net = torch.load(exp / "models" / "net_g_2.pth", weights_only=True)
    from textualdegremoval_tpu_torch.models import define_network
    define_network(NET).load_state_dict(net["params"], strict=True)
    for r in ranks:
        assert r["step"] == 2
        for k, v in r["params"].items():
            assert torch.equal(net["params"][k], v), k
    # a third process resumes from iteration 2
    resumed = _run(tmp_path, "cli_restoration",
                   argv[:-1] + ["3"], 1)[0]
    assert resumed["step"] == 3
    assert "auto-resumed from iter 2" in (exp / "train.log").read_text()


def test_diffir_cli_two_ranks(tmp_path):
    from test_torch_diffir import _diffir_opt

    _pngs(tmp_path, 4)
    cfg = tmp_path / "diffir.json"
    opt = _diffir_opt(tmp_path, "dist_diffir")
    opt["datasets"]["train"]["batch_size_per_gpu"] = 1
    cfg.write_text(json.dumps(opt))
    ranks = _run(tmp_path, "cli_diffir",
                 ["--opt", str(cfg), "--device", "cpu", "--max_iters", "2"],
                 2)
    exp = tmp_path / "experiments" / "dist_diffir"
    lines = (exp / "train.log").read_text().splitlines()
    assert sum("l_pix: " in line for line in lines) == 2
    assert len((exp / "scalars.jsonl").read_text().splitlines()) == 2
    net = torch.load(exp / "models" / "net_g_2.pth", weights_only=True)
    for r in ranks:
        assert r["step"] == 2
        for k, v in r["params"].items():
            assert torch.equal(net["params"][k], v), k


def test_i2t_cli_two_ranks(tmp_path):
    from test_torch_cli_train_guidance import _cli_argv, _write_images

    data = _write_images(tmp_path / "hq", [(40, 52), (24, 30), (64, 36),
                                           (33, 33)], 0)
    ranks = _run(tmp_path, "cli_i2t",
                 _cli_argv(data, tmp_path / "out", "--random_init",
                           "--scale_lr"), 2)
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    saved = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert saved == ["i2t_params_2"]
    mapper = torch.load(tmp_path / "out" / "i2t_params_2" / "mapper.pt",
                        weights_only=True)
    assert mapper


@pytest.mark.slow
def test_restoration_cli_four_ranks_match_one_process(tmp_path):
    """tests/test_multihost.py's check on the port: four ranks at batch 1
    over four identical images against one process at batch 4, the crop
    the whole image, no augmentation: the global batch is the same, so
    the ranks' model equals the single process's within the DP bounds."""
    opts = {}
    for name, batch in (("four", 1), ("one", 4)):
        root = tmp_path / name
        root.mkdir()
        cfg = root / "opt.json"
        cfg.write_text(json.dumps(_restoration_opt(
            root, f"mh_{name}", batch, gt_size=32, val=False,
            hw=(32, 32))))
        opts[name] = (root, ["--opt", str(cfg), "--device", "cpu",
                             "--max_iters", "2"])
    four = _run(opts["four"][0], "cli_restoration", opts["four"][1], 4)
    one = _run(opts["one"][0], "cli_restoration", opts["one"][1], 1)[0]
    for r in four:
        for k, v in one["params"].items():
            torch.testing.assert_close(r["params"][k], v, rtol=0, atol=4e-6)
