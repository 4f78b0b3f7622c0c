"""The evaluate CLI's --spatial_shard on the CPU: two gloo ranks, each a
process of tests/torch_dist_worker.py (case `cli_evaluate`) under the
torch launcher's env, on images whose height is odd (JAX's reflect pad to
a multiple of the ranks, then the crop back).  The sharded CLI against
JAX's `model.apply` on the reflect-padded input (what JAX's sharded CLI
computes; tests/test_spatial_sharding.py holds JAX's sharded forward
equal to it), and against JAX's CLI --spatial_shard 2 on eight host
devices in a process of its own (about 14 s alone: its compile stays far
from the 30 s that would put it under `slow`).  The refusals: three
shards on two ranks (JAX's device check, devices read as ranks), the
routes the sharded forward does not serve, each refusal naming the
network; --spatial_shard 1 is the unsharded run.
`jax_reflect_padded_scores` and the JAX CLI's process
(`start_jax_sharded_cli`) serve the other families' files too
(tests/test_torch_spatial_naf.py, tests/test_torch_spatial_promptir.py,
tests/test_torch_spatial_drsformer.py, tests/test_torch_spatial_sfnet.py)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as dw
from test_torch_spatial import TINY_REF, trained_scale

from textualdegremoval_tpu_torch.data.png import write_png
from textualdegremoval_tpu_torch.models.restormer import RestormerRefFusion

IMAGES, HW = 2, (37, 40)  # H odd: reflect-padded to 38 for two shards


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_cli")
    write_eval_images(root, HW, 11)
    model = trained_scale(RestormerRefFusion(**TINY_REF), seed=3)
    torch.save({"params": model.state_dict()}, root / "net_g.pth")
    return root


def cli_argv(root, task, ckpt, *extra):
    """The CPU evaluate CLI on `root`'s hq and ref folders, --tiny_debug,
    the checkpoint root / ckpt."""
    return ["--task", task, "--tiny_debug", "--sigma", "15",
            "--hqroot", str(root / "hq"), "--refroot", str(root / "ref"),
            "--checkpoint_path", str(root / ckpt), "--device", "cpu", *extra]


def _argv(root, *extra):
    return cli_argv(root, "tiny_smoke", "net_g.pth", *extra)


def write_eval_images(root, hw, seed, images=IMAGES):
    """`images` PNGs of hw under root/hq, and under root/ref their first
    32 rows mirrored."""
    rng = np.random.default_rng(seed)
    for sub in ("hq", "ref"):
        (root / sub).mkdir()
    for i in range(images):
        img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        write_png(str(root / "hq" / f"{i}.png"), img)
        write_png(str(root / "ref" / f"{i}.png"),
                  np.ascontiguousarray(img[:32, ::-1]))


@functools.lru_cache(maxsize=None)
def jax_apply(task):
    """`jax.jit(model.apply)` of the JAX CLI's --tiny_debug network of
    `task`, one a task (its compiles shared by the tests of a process)."""
    import jax

    from textualdegremoval_tpu.cli import evaluate as jcli

    opt = jcli.shrink_for_smoke(dict(jcli.TASK_TABLE[task]))
    return jax.jit(jcli.define_network(opt).apply)


def jax_reflect_padded_scores(root, task, ckpt, shards=2, images=IMAGES):
    """JAX's sharded CLI computes `model.apply` on lq reflect-padded to a
    multiple of the shards, cropped back: that, image by image, from JAX's
    CLI's own pieces (its reader, noise protocol, network table, last
    output and metrics).  Returns (mean PSNR, mean SSIM)."""
    from textualdegremoval_tpu.cli import evaluate as jcli
    from textualdegremoval_tpu.convert.torch_to_jax import split_batch_stats

    variables = split_batch_stats(jcli.load_torch_checkpoint(
        str(root / ckpt)))
    fwd = jax_apply(task)
    psnrs, ssims = [], []
    for i in range(images):
        hq = jcli.imread_f32(str(root / "hq" / f"{i}.png"))
        ref = jcli.imread_f32(str(root / "ref" / f"{i}.png"))
        rng = np.random.RandomState(0)
        lq = hq + rng.randn(*hq.shape).astype(np.float32) * 15 / 255.0
        lq = np.pad(lq, ((0, (-lq.shape[0]) % shards), (0, 0), (0, 0)),
                    "reflect")
        pred = np.clip(np.asarray(jcli._last(fwd(variables, lq[None],
                                                 ref[None])))[0],
                       0, 1)[: hq.shape[0]]
        psnrs.append(jcli.calculate_psnr(pred * 255, hq * 255, crop_border=0))
        ssims.append(jcli.calculate_ssim(pred * 255, hq * 255, crop_border=0))
    return float(np.mean(psnrs)), float(np.mean(ssims))


def start_jax_sharded_cli(argv):
    """JAX's CLI on argv (the port's, --device dropped) in a process of its
    own with tests/conftest.py's eight host devices; returns the process,
    which `jax_cli_result` reads."""
    argv = [a for a in argv if a not in ("--device", "cpu")]
    code = ("import sys; from textualdegremoval_tpu.cli.evaluate import main;"
            " print(repr(main(sys.argv[1:])))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(dw.REPO))
    return subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(dw.REPO))


def jax_cli_result(proc):
    """(mean PSNR, mean SSIM) that a `start_jax_sharded_cli` process
    printed."""
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return eval(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sharded(eval_dirs, tmp_path_factory):
    """Each rank's results of: --spatial_shard 3 (refused on two ranks),
    then --spatial_shard 2."""
    work = tmp_path_factory.mktemp("spatial_cli_ranks")
    torch.save({"argvs": [_argv(eval_dirs, "--spatial_shard", "3"),
                          _argv(eval_dirs, "--spatial_shard", "2")]},
               work / "input.pt")
    return dw.spawn("cli_evaluate", work, 2)


def test_three_shards_on_two_ranks_refuse(sharded):
    for rank_out in sharded:
        assert rank_out[0] == "--spatial_shard 3 needs 3 ranks, have 2"


def test_sharded_cli_scores_on_rank0_only(sharded):
    assert sharded[1][1] is None
    psnr, ssim = sharded[0][1]
    assert np.isfinite(psnr) and np.isfinite(ssim)


def test_sharded_cli_equals_jax_on_reflect_padded_input(sharded, eval_dirs):
    """JAX's sharded CLI computes `model.apply` on lq reflect-padded to a
    multiple of the shards, cropped back (`jax_reflect_padded_scores`)."""
    want = jax_reflect_padded_scores(eval_dirs, "tiny_smoke", "net_g.pth")
    psnr, ssim = sharded[0][1]
    assert abs(psnr - want[0]) < 1e-3
    assert abs(ssim - want[1]) < 1e-4


def test_one_shard_is_the_unsharded_run(eval_dirs):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    assert main(_argv(eval_dirs, "--spatial_shard", "1")) == \
        main(_argv(eval_dirs))


@pytest.mark.parametrize("task,extra,named", [
    ("promptir_all_in_one", ("--chain",), "--chain"),
    ("drsformer_derain", ("--chain",), "DRSformerRefFusion"),
    ("sfnet_dehaze_indoor", ("--module_blocks",), "SFNetRefFusion"),
    ("tiny_smoke", ("--chain",), "--chain"),
    ("tiny_smoke", ("--module_blocks",), "--module_blocks"),
    ("tiny_smoke", ("--module_blocks", "--gdfn_kernel"), "--gdfn_kernel"),
])
def test_sharding_refuses_what_it_does_not_serve(eval_dirs, task, extra,
                                                 named):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = _argv(eval_dirs, "--spatial_shard", "2", *extra)
    argv[1] = task
    with pytest.raises(SystemExit, match=named):
        main(argv)


def test_sharding_refuses_one_rank(eval_dirs):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    with pytest.raises(SystemExit, match="needs 2 ranks, have 1"):
        main(_argv(eval_dirs, "--spatial_shard", "2"))


def test_sharded_cli_equals_jax_sharded_cli(sharded, eval_dirs):
    """JAX's CLI --spatial_shard 2 on a (1, 2) mesh of host devices, in a
    process of its own with tests/conftest.py's eight host devices."""
    want = jax_cli_result(start_jax_sharded_cli(
        _argv(eval_dirs, "--spatial_shard", "2")))
    psnr, ssim = sharded[0][1]
    assert abs(psnr - want[0]) < 1e-3 and abs(ssim - want[1]) < 1e-4
