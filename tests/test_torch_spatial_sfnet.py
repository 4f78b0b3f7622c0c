"""The row-sharded SFNetRefFusion (the evaluate CLI's --spatial_shard on
`sfnet_dehaze_indoor` and `sfnet_dehaze_outdoor`) against the unsharded
port and JAX, on the CPU: each world of ranks is spawned once
(tests/torch_dist_worker.py case `spatial_pools`, gloo) and its results
read by the tests below.

The TLC box pools of Gap and SFconv are the whole image's at the slab's
rows: each rank's partial box sums of every output row of the valid
window, summed over the ranks, the kernel from the image's height at
that level (parallel/spatial.py `box_mean_rows`), held here against
ops/tlc.py `local_avg_pool` on the whole image.  PatchAP's 2 x 2
patch-strided view pools each quadrant of the image on its own, so a
slab that straddles H / 2 pools two regions (models/sfnet.py
`patch_pool`).  The SCM's InstanceNorm and the dynamic filters' means
are the slab's own rows' float32 sums, summed over the ranks; the
filters' taps read a reflected halo (`reflect_rows`, held against
F.pad(mode="reflect")).  JAX's bound for its sharded forward, atol 1e-4,
holds all three scales here against the unsharded port and JAX's
`model.apply`.  The tiny networks of `--tiny_debug` (base channel 8,
lr_block_size 4: units of 16 rows, 4 at the quarter scale) at TLC bases
246 and 210: 5 units shared 3 + 2 and 2 + 2 + 1 (slabs straddling each
scale's H / 2), and 2 units shared 1 + 1 + 0 (a rank with no rows).
Weights at a trained network's scale with every zero-initialised gate
(Gap's fscales, PatchAP's h and l, the fusion alphas) away from zero and
the BatchNorm buffers away from 0 and 1, so that each planted fault
misses the bound: the TLC pool of the slab alone (its kernel from the
slab's height), PatchAP's view taken of the slab, and a rank without
rows whose sums count.  The CLI as tests/test_torch_spatial_drsformer.py
runs it, for both tasks."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_spatial import trained_scale
from test_torch_spatial_cli import cli_argv, jax_cli_result
from test_torch_spatial_drsformer import (
    OPTS, make_eval_dirs, model_inputs, padded, spawn_worlds,
    unsharded_forwards,
)
from torch_port_util import (  # noqa: F401  (a fixture)
    assert_close, randn, t, torch_share_of_cores,
)

from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.sfnet import (
    SCM, PatchAP, SFResBlock,
)
from textualdegremoval_tpu_torch.ops.tlc import local_avg_pool
from textualdegremoval_tpu_torch.parallel.spatial import RowShard

TASK, OUT_TASK = "sfnet_dehaze_indoor", "sfnet_dehaze_outdoor"
ATOL = 1e-4  # JAX's own bound, sharded against unsharded
MODEL_CASES = {  # name: (task, lq height, width)
    "uneven": (TASK, 70, 40),  # 5 units: 3 + 2 on two ranks, 2 + 2 + 1
    "empty": (TASK, 30, 36),   # 2 units: 1 + 1 + 0 on three ranks
    "uneven_out": (OUT_TASK, 70, 40),
    "empty_out": (OUT_TASK, 30, 36),
}
PLANTS = {2: [("tlc_slab_height", "uneven"),
              ("patch_slab_unshuffle", "uneven")],
          3: [("tlc_slab_height", "uneven"),
              ("patch_slab_unshuffle", "uneven"),
              ("empty_counted", "empty")]}
# the box mean: (image (H, W, C), kernel, unit); 24 rows in units of 4 are
# 3 + 3 and 2 + 2 + 2 units, 8 rows 1 + 1 and 1 + 1 + 0
BOX_CASES = {
    "kernel_shorter_than_a_slab": ((24, 10, 3), (3, 4), 4),
    "kernel_spanning_three_ranks": ((24, 10, 3), (20, 5), 4),
    "base_246": ((24, 20, 3), (24 * 246 // 256, 20 * 246 // 256), 4),
    "base_210": ((24, 20, 3), (24 * 210 // 256, 20 * 210 // 256), 4),
    "global_mean": ((24, 10, 3), (30, 12), 4),
    "base_246_empty_rank": ((8, 10, 3), (8 * 246 // 256, 10 * 246 // 256),
                            4),
}
# the reflect halo: (image (H, W, C), rows, unit): 16 rows 2 + 2 and
# 2 + 1 + 1 units, 8 rows 1 + 1 and 1 + 1 + 0
REFLECT_CASES = (((14, 5, 2), 2, 4), ((14, 5, 2), 1, 4), ((8, 5, 2), 2, 4))
# single modules on a slab in units of 4 rows: PatchAP on 20 rows (3 + 2
# and 2 + 2 + 1 units: rank 0's, and rank 1's, slab straddles row 10),
# an SFResBlock with both dynamic filters and an SCM on 16 rows
BLOCKS = (("PatchAP", (4, 2, 246), (20, 12), 4),
          ("SFResBlock", (8, True, 246), (14, 12), 4),
          ("SCM", (16,), (14, 12), 4))
# the CLI's images, by task: reflect-padded to 70 and 30 rows, a JAX case's
# shapes, whose compile the CLI's comparison reuses
CLI_HW = {TASK: (69, 40), OUT_TASK: (29, 36)}
# the cases held against JAX's `model.apply`, one compile a task (the
# others against the unsharded port only)
JAX_CASES = ("uneven", "empty_out")


def sf_scale(module: torch.nn.Module, seed: int):
    """`trained_scale`, then Gap's fscales in [0.5, 1.5], PatchAP's h in
    [0.25, 0.75] and l in [1.25, 1.75] (its output x h + pool (l - h) is 0
    at h = l = 0, and loses its pool at h = l), the BatchNorm means
    N(0, 0.5^2) and variances in [0.5, 1.5]."""
    trained_scale(module, seed)
    rng = np.random.default_rng(seed + 1000)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("fscale_d", "fscale_h", "l"):
                p.copy_(t(0.5 + rng.random(p.shape, np.float32)
                          + 0.75 * (leaf == "l")))
            elif leaf == "h":
                p.copy_(t(0.25 + 0.5 * rng.random(p.shape, np.float32)))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(t(randn(rng, *b.shape, scale=0.5)))
            elif name.endswith("running_var"):
                b.copy_(t(0.5 + rng.random(b.shape, np.float32)))
    return module


def _model(task, seed):
    return sf_scale(define_network(dict(OPTS[task])), seed).eval()


def _block(module, args, seed):
    cls = {"PatchAP": PatchAP, "SFResBlock": SFResBlock, "SCM": SCM}[module]
    return sf_scale(cls(*args), seed).eval()


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    return make_eval_dirs(tmp_path_factory, "spatial_sf_cli", CLI_HW,
                          _model, 37)


def _argv(roots, task, *extra):
    return cli_argv(roots[task], task, "net.pth", *extra)


def _inputs(roots):
    rng = np.random.default_rng(29)
    blocks = []
    for i, (module, args, hw, unit) in enumerate(BLOCKS):
        c = args[0] if module != "SCM" else 3
        blocks.append({"module": module, "args": args, "unit": unit,
                       "state": _block(module, args, 50 + i).state_dict(),
                       "x": t(randn(rng, 1, *hw, c))})
    return {"box": [(t(randn(rng, 1, *hw)), k, u)
                    for hw, k, u in BOX_CASES.values()],
            "reflect": [(t(randn(rng, 1, *hw)), r, u)
                        for hw, r, u in REFLECT_CASES],
            "blocks": blocks,
            "models": model_inputs(MODEL_CASES, _model, 31, ramp=0.5),
            "plants": PLANTS,
            "argvs": {2: [_argv(roots, task, "--spatial_shard", "2")
                          for task in CLI_HW]}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, eval_dirs):
    return spawn_worlds(tmp_path_factory, "spatial_sf", _inputs(eval_dirs),
                        MODEL_CASES, JAX_CASES, eval_dirs, TASK)


@pytest.fixture(scope="module")
def unsharded(spawned):
    return unsharded_forwards(spawned[0])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("i,name", enumerate(BOX_CASES))
def test_sharded_box_mean_equals_local_avg_pool(spawned, world, i, name):
    """`box_mean_rows` on each rank's slab, gathered, against
    `local_avg_pool` on the whole (padded) image."""
    img, kernel, unit = spawned[0]["box"][i]
    img = padded(img, unit)
    want = local_avg_pool(img, kernel)
    if name == "global_mean":
        assert want.shape[1:3] == (1, 1)
    assert_close(spawned[1][world][0]["box"][i], want.expand_as(img),
                 atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("i", range(len(REFLECT_CASES)))
def test_reflect_halo_equals_reflect_pad(spawned, world, i):
    """Each rank's slab with r rows of each neighbour's, reflected within
    its own rows at the image's true top and bottom, against
    F.pad(mode="reflect") of the whole (padded) image."""
    img, r, unit = spawned[0]["reflect"][i]
    whole = F.pad(padded(img, unit).permute(0, 3, 1, 2), (0, 0, r, r),
                  mode="reflect").permute(0, 2, 3, 1)
    seen = 0
    for start, rows, ext in (o["reflect"][i] for o in spawned[1][world]):
        if rows:
            assert torch.equal(ext, whole[:, start: start + rows + 2 * r])
            seen += rows
    assert seen == whole.shape[1] - 2 * r


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("i", range(len(BLOCKS)), ids=[b[0] for b in BLOCKS])
def test_sharded_module_equals_whole_module(spawned, world, i,
                                           torch_share_of_cores):
    """PatchAP on slabs that straddle H / 2, an SFResBlock with its dynamic
    filters and an SCM, each on each rank's slab, against the module on
    the whole (padded) input."""
    blk = spawned[0]["blocks"][i]
    m = _block(blk["module"], blk["args"], 0)
    m.load_state_dict(blk["state"])
    x = padded(blk["x"], blk["unit"])
    with torch.no_grad():
        want = m(x)
    assert_close(spawned[1][world][0]["blocks"][i], want, atol=ATOL, rtol=0)
    moved = want - x if want.shape == x.shape else want  # the SCM: 3 -> 16
    assert moved.abs().max() > 0.1


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_sharded_model_equals_unsharded_port(spawned, unsharded, world,
                                             name):
    """All three scales, each gathered at its layout."""
    h = MODEL_CASES[name][1]
    got = spawned[1][world][0]["model"][name]
    assert got[-1].shape[1] % 16 == 0
    for f, g, want in zip((4, 2, 1), got, unsharded[name]):
        assert_close(g[:, : h // f], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_model_equals_jax(spawned, name):
    """The three-rank forward's three scales against JAX's `model.apply`
    on the same input and weights."""
    h = MODEL_CASES[name][1]
    got = spawned[1][3][0]["model"][name]
    for f, g, want in zip((4, 2, 1), got, spawned[3][0][name]):
        assert g[:, : h // f].shape == want.shape
        assert_close(g[:, : h // f], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("world,plant,name", [
    (w, p, n) for w, plants in PLANTS.items() for p, n in plants])
def test_planted_faults_fail_the_bound(spawned, unsharded, world, plant,
                                       name):
    """The TLC pool of the slab alone, PatchAP's view of the slab, or a
    rank without rows whose sums count, must miss the bound the sharded
    forward meets."""
    h = MODEL_CASES[name][1]
    got = spawned[1][world][0]["planted"][plant]
    err = max((g[:, : h // f] - want).abs().max().item()
              for f, g, want in zip((4, 2, 1), got, unsharded[name]))
    assert err > 100 * ATOL, f"{plant}: {err}"


@pytest.mark.parametrize("task", [TASK, OUT_TASK])
def test_one_rank_shard_equals_unsharded(task, torch_share_of_cores):
    """A one-rank layout runs every sharded module with no neighbours:
    equal to the unsharded forward but for the box sums' order (row sums
    then their prefix, where `local_avg_pool` takes the 2-D integral
    image) and the moments' float32 sums over the pixel count: a few
    float32 ulps, carried on to a few 1e-6 of the output."""
    m = _model(task, 7)
    rng = np.random.default_rng(7)
    lq, ref = t(rng.random((1, 40, 36, 3), np.float32)), t(
        rng.random((1, 32, 32, 3), np.float32))
    s = RowShard.split(40, m.row_unit, 0, 1)
    with torch.no_grad():
        want = m(lq, ref)
        got = m(s.slab(lq), ref, shard=s)
    for f, g, w in zip((4, 2, 1), got, want):
        assert_close(g[:, : 40 // f], w, atol=2e-5, rtol=0)


def test_shard_refusals(torch_share_of_cores):
    m = _model(TASK, 0)
    s = RowShard.split(64, m.row_unit, 0, 1)
    lq, ref = torch.rand(1, 64, 32, 3), torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="slab of 40 rows"), torch.no_grad():
        m(lq[:, :40], ref, shard=s)
    with pytest.raises(ValueError, match="eval mode"), torch.no_grad():
        m.train()(lq, ref, shard=s)
    x = torch.rand(1, 4, 8, 4)
    dyna = m.Encoder[0].layers[-1].dyna_2.eval()
    with pytest.raises(ValueError, match="DynamicFilter: a halo of 2 rows"), \
            torch.no_grad():
        dyna(x, RowShard.split(4, 1, 0, 1))


@pytest.mark.parametrize("i,task", enumerate(CLI_HW))
def test_sharded_cli_equals_jax_on_reflect_padded_input(spawned, i, task):
    """Rank 0 scores SFNet's finest scale (rank 1 returns None) as JAX's
    `model.apply` does on the reflect-padded input
    (`jax_reflect_padded_scores`)."""
    runs = spawned[1][2]
    assert runs[1]["cli"] == [None, None]
    psnr, ssim = runs[0]["cli"][i]
    want = spawned[3][1][task]
    assert abs(psnr - want[0]) < 1e-3
    assert abs(ssim - want[1]) < 1e-4


def test_sharded_cli_equals_jax_sharded_cli(spawned):
    """JAX's CLI --spatial_shard 2 on a (1, 2) mesh of host devices."""
    want = jax_cli_result(spawned[2])
    psnr, ssim = spawned[1][2][0]["cli"][0]
    assert abs(psnr - want[0]) < 1e-3 and abs(ssim - want[1]) < 1e-4


def test_one_shard_is_the_unsharded_run(eval_dirs, torch_share_of_cores):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    assert main(_argv(eval_dirs, OUT_TASK, "--spatial_shard", "1")) == \
        main(_argv(eval_dirs, OUT_TASK))
