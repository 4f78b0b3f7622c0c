"""The row-sharded NAFNetRefFusion (the evaluate CLI's --spatial_shard on
`nafnet_deblur`) against the unsharded port and JAX, on the CPU: each
world of ranks is spawned once (tests/torch_dist_worker.py case
`spatial_family`, gloo) and its results read by the tests below.

A sharded NAFBlock runs on its slab and one row of each neighbour's (the
depthwise conv on conv1's output), its SCA sums over its own rows only,
summed over the ranks in float32 and divided by the whole image's pixel
count (ops/pallas/nafblock.py `sca_pool`).  JAX's bound for its sharded
forward, atol 1e-4, holds the port's here against its unsharded forward
and against JAX's `model.apply`.  The tiny network of `--tiny_debug`
(width 8, lr_block_size 4: units of 64 rows) at heights that are not
multiples of the unit: 3 units shared 2 + 1 and 1 + 1 + 1, and 2 units
shared 1 + 1 + 0 (a rank with no rows).  Weights at a trained network's
scale with the SCA bias, beta and gamma in [0.5, 1.5], so that each pool
moves the output and both planted faults (the halo rows counted in the
SCA sums, the slab's H x W as the divisor) miss the bound.  The CLI: two
ranks on images of odd height (reflect-padded, then the crop back)
against JAX's `model.apply` on the reflect-padded input and JAX's CLI
--spatial_shard 2 in a process of its own, started first so that it runs
beside the ranks, as JAX's compiles do in a thread."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_dist_worker as dw
from test_torch_spatial import trained_scale
from test_torch_spatial_cli import (
    cli_argv, jax_apply, jax_cli_result, jax_reflect_padded_scores,
    start_jax_sharded_cli, write_eval_images,
)
from torch_port_util import assert_close, randn, t

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, shrink_for_smoke,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.layers import NAFBlock
from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
from textualdegremoval_tpu_torch.parallel.spatial import RowShard

TASK = "nafnet_deblur"
OPT = shrink_for_smoke(dict(TASK_TABLE[TASK]))
ATOL = 1e-4  # JAX's own bound, sharded against unsharded
MODEL_CASES = {  # name: (lq height, width)
    "uneven": (132, 40),  # 3 units: 2 + 1 on two ranks, 1 + 1 + 1 on three
    "empty": (70, 36),    # 2 units: 1 + 1 + 0 on three ranks
}
PLANTS = ("halo_counted", "slab_divisor")
BLOCK_HW, BLOCK_UNIT, BLOCK_C = (13, 9), 4, 16  # 4 units: 2 + 2, 2 + 1 + 1
# reflect-padded to 132: 3 units, 2 + 1 on two ranks; the shapes of the
# uneven case, whose JAX compile the CLI's comparison reuses
CLI_HW = (131, 40)


def naf_scale(module: torch.nn.Module, seed: int):
    """`trained_scale`, then the SCA bias, beta and gamma drawn in [0.5,
    1.5]: the SCA scale O(1) and neither residual branch near zero."""
    trained_scale(module, seed)
    rng = np.random.default_rng(seed + 1000)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("beta", "gamma", "sca.1.bias")):
                p.copy_(t(0.5 + rng.random(p.shape, np.float32)))
    return module


def _model(seed):
    return naf_scale(define_network(dict(OPT)), seed).eval()


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_naf_cli")
    write_eval_images(root, CLI_HW, 23)
    torch.save({"params": _model(9).state_dict()}, root / "net_naf.pth")
    return root


def _argv(root, *extra):
    return cli_argv(root, TASK, "net_naf.pth", *extra)


def _inputs():
    rng = np.random.default_rng(13)
    models = {}
    for i, (name, (h, w)) in enumerate(MODEL_CASES.items()):
        models[name] = {
            "opt": OPT, "state": _model(i).state_dict(),
            "lq": t(rng.random((1, h, w, 3), np.float32)),
            "ref": t(rng.random((1, 32, 40, 3), np.float32))}
    blk = naf_scale(NAFBlock(BLOCK_C), 5)
    return {"block": {"x": t(randn(rng, 1, *BLOCK_HW, BLOCK_C)),
                      "p": {k: v.detach()
                            for k, v in blk.block_params().items()},
                      "unit": BLOCK_UNIT},
            "models": models,
            "plants": [(plant, "uneven") for plant in PLANTS]}


def _jax_side(inp, root):
    """JAX's `model.apply` of each model case and
    `jax_reflect_padded_scores` of the CLI's folder."""
    import jax.numpy as jnp

    from textualdegremoval_tpu.convert import convert_state_dict

    models = {name: jax_apply(TASK)(
        {"params": convert_state_dict(case["state"])},
        jnp.asarray(case["lq"].numpy()), jnp.asarray(case["ref"].numpy()))
        for name, case in inp["models"].items()}
    return models, jax_reflect_padded_scores(root, TASK, "net_naf.pth")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, eval_dirs):
    """JAX's sharded CLI started first and JAX's forwards in a thread, then
    each world's ranks once (two ranks also run the CLI); (inputs, {world:
    rank outputs}, JAX CLI's process, (JAX's forward of each model case,
    JAX's scores of the CLI's folder))."""
    jax_cli = start_jax_sharded_cli(_argv(eval_dirs, "--spatial_shard", "2"))
    inp = _inputs()
    pool = ThreadPoolExecutor(1)
    jax_side = pool.submit(_jax_side, inp, eval_dirs)
    runs = {}
    for world in (2, 3):
        work = tmp_path_factory.mktemp(f"spatial_naf{world}")
        argvs = ([_argv(eval_dirs, "--spatial_shard", "2")] if world == 2
                 else [])
        torch.save({**inp, "argvs": argvs}, work / "input.pt")
        runs[world] = dw.spawn("spatial_family", work, world)
    pool.shutdown()
    return inp, runs, jax_cli, jax_side.result()


@pytest.fixture(scope="module")
def unsharded(spawned):
    """The port's unsharded forward of each model case."""
    inp = spawned[0]
    out = {}
    for name, case in inp["models"].items():
        m = define_network(dict(case["opt"]))
        m.load_state_dict(case["state"])
        with torch.no_grad():
            out[name] = m.eval()(case["lq"], case["ref"])
    return out


def _padded(img, unit):
    h = img.shape[1]
    return torch.nn.functional.pad(img, (0, 0, 0, 0, 0, (-h) % unit))


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_nafblock_equals_whole_block(spawned, world):
    """`nafblock_ref` on each rank's slab with its 1-row halo and the SCA
    sums summed over the ranks, against the block on the whole (padded)
    image."""
    inp, runs = spawned[:2]
    blk = inp["block"]
    x = _padded(blk["x"], BLOCK_UNIT)
    with torch.no_grad():
        want = nb.nafblock_ref(x, blk["p"])
    assert_close(runs[world][0]["block"], want, atol=ATOL, rtol=0)
    assert (want - x).abs().max() > 0.1  # the block adds O(1)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_sharded_model_equals_unsharded_port(spawned, unsharded, world,
                                             name):
    h = MODEL_CASES[name][0]
    got = spawned[1][world][0]["model"][name]
    assert got.shape[1] % 64 == 0
    assert_close(got[:, :h], unsharded[name], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_sharded_model_equals_jax(spawned, name):
    """The three-rank forward against JAX's `model.apply` on the same
    input and weights."""
    inp, runs = spawned[:2]
    want = spawned[3][0][name]
    got = runs[3][0]["model"][name][:, : inp["models"][name]["lq"].shape[1]]
    assert got.shape == want.shape
    assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("plant", PLANTS)
def test_planted_faults_fail_the_bound(spawned, unsharded, world, plant):
    """The halo rows counted in the SCA sums, or the slab's H x W as their
    divisor, must miss the bound the sharded forward meets."""
    got = spawned[1][world][0]["planted"][plant][
        :, : MODEL_CASES["uneven"][0]]
    err = (got - unsharded["uneven"]).abs().max().item()
    assert err > 100 * ATOL, f"{plant}: {err}"


def test_one_rank_shard_equals_unsharded():
    """A one-rank layout runs every sharded module with no neighbours:
    equal to the unsharded forward bit for bit."""
    m = _model(7)
    rng = np.random.default_rng(7)
    lq, ref = t(rng.random((1, 70, 36, 3), np.float32)), t(
        rng.random((1, 32, 32, 3), np.float32))
    s = RowShard.split(70, m.row_unit, 0, 1)
    with torch.no_grad():
        want = m(lq, ref)
        got = m(s.slab(lq), ref, shard=s)
    assert torch.equal(got[:, :70], want)


def test_shard_refusals():
    m = _model(0)
    s = RowShard.split(128, m.row_unit, 0, 1)
    lq, ref = torch.rand(1, 128, 32, 3), torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="slab of 70 rows"):
        m(lq[:, :70], ref, shard=s)
    blk = m.encoders[0][0]
    x = torch.rand(1, 8, 8, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        blk(x, shard=RowShard.split(8, 4, 0, 1))
    tlc = NAFBlock(8, tlc_kernel=(3, 3))
    with pytest.raises(ValueError, match="module path"), torch.no_grad():
        tlc(torch.rand(1, 8, 8, 8), shard=RowShard.split(8, 4, 0, 1))


def test_sharded_cli_equals_jax_on_reflect_padded_input(spawned):
    """Rank 0 scores (rank 1 returns None) what JAX's `model.apply` scores
    on the reflect-padded input (`jax_reflect_padded_scores`)."""
    runs = spawned[1][2]
    assert runs[1]["cli"] == [None]
    psnr, ssim = runs[0]["cli"][0]
    want = spawned[3][1]
    assert abs(psnr - want[0]) < 1e-3
    assert abs(ssim - want[1]) < 1e-4


def test_sharded_cli_equals_jax_sharded_cli(spawned):
    """JAX's CLI --spatial_shard 2 on a (1, 2) mesh of host devices."""
    want = jax_cli_result(spawned[2])
    psnr, ssim = spawned[1][2][0]["cli"][0]
    assert abs(psnr - want[0]) < 1e-3 and abs(ssim - want[1]) < 1e-4


def test_one_shard_is_the_unsharded_run(eval_dirs):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    assert main(_argv(eval_dirs, "--spatial_shard", "1")) == \
        main(_argv(eval_dirs))
