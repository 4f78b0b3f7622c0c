"""The row-sharded PromptIRRefFusion (the evaluate CLI's --spatial_shard on
`promptir_all_in_one`) against the unsharded port and JAX, on the CPU:
each world of ranks is spawned once (tests/torch_dist_worker.py case
`spatial_family`, gloo) and its results read by the tests below.

Its TransformerBlocks run sharded as RestormerRefFusion's do
(tests/test_torch_spatial.py), the noise blocks at three more widths; each
PromptGenBlock takes the float32 sums of its slab's own rows, summed over
the ranks, over the whole image's pixel count, and resizes its prompt to
the whole image's height before the 3x3 conv reads the slab's rows of it
with one row of each neighbour's (models/promptir.py `prompt_rows`).
JAX's bound for its sharded forward, atol 1e-4, holds the port's here
against its unsharded forward and against JAX's `model.apply`.  The tiny
network of `--tiny_debug` (dim 8, lr_block_size 4: units of 32 rows) at
heights that are not multiples of the unit: 3 units shared 2 + 1 and 1 +
1 + 1, and 2 units shared 1 + 1 + 0 (a rank with no rows).  Weights at a
trained network's scale with the prompt banks N(0, 1), so that the prompts
move the output and both planted faults (the prompt resized at the slab's
height, the mean's sums not summed over the ranks) miss the bound.  The
CLI: two ranks on images of odd height (reflect-padded, then the crop
back) against JAX's `model.apply` on the reflect-padded input and JAX's
CLI --spatial_shard 2 in a process of its own, started first so that it
runs beside the ranks, as JAX's compiles do in a thread."""

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
from textualdegremoval_tpu_torch.models.promptir import PromptGenBlock
from textualdegremoval_tpu_torch.parallel.spatial import RowShard

TASK = "promptir_all_in_one"
OPT = shrink_for_smoke(dict(TASK_TABLE[TASK]))
ATOL = 1e-4  # JAX's own bound, sharded against unsharded
MODEL_CASES = {  # name: (lq height, width)
    "uneven": (70, 40),  # 3 units: 2 + 1 on two ranks, 1 + 1 + 1 on three
    "empty": (40, 36),   # 2 units: 1 + 1 + 0 on three ranks
}
PLANTS = ("prompt_slab_height", "prompt_unreduced")
# a PromptGenBlock (prompt dim, length, size, lin_dim) on (1, 13, 9,
# lin_dim) in units of 4 rows: 2 + 2 and 2 + 1 + 1, the prompt resized up
BLOCK_ARGS, BLOCK_HW, BLOCK_UNIT = (16, 5, 4, 8), (13, 9), 4
# reflect-padded to 70: 3 units, 2 + 1 on two ranks; the shapes of the
# uneven case, whose JAX compile the CLI's comparison reuses
CLI_HW = (69, 40)


def prompt_scale(module: torch.nn.Module, seed: int):
    """`trained_scale`, then the prompt banks N(0, 1)."""
    trained_scale(module, seed)
    rng = np.random.default_rng(seed + 1000)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("prompt_param"):
                p.copy_(t(randn(rng, *p.shape)))
    return module


def _model(seed):
    return prompt_scale(define_network(dict(OPT)), seed).eval()


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_pir_cli")
    write_eval_images(root, CLI_HW, 29)
    torch.save({"params": _model(9).state_dict()}, root / "net_pir.pth")
    return root


def _argv(root, *extra):
    return cli_argv(root, TASK, "net_pir.pth", *extra)


def _inputs():
    rng = np.random.default_rng(17)
    models = {}
    for i, (name, (h, w)) in enumerate(MODEL_CASES.items()):
        models[name] = {
            "opt": OPT, "state": _model(i).state_dict(),
            "lq": t(rng.random((1, h, w, 3), np.float32)),
            "ref": t(rng.random((1, 32, 40, 3), np.float32))}
    blk = prompt_scale(PromptGenBlock(*BLOCK_ARGS), 5)
    return {"block": {"x": t(randn(rng, 1, *BLOCK_HW, BLOCK_ARGS[-1])),
                      "args": BLOCK_ARGS, "state": blk.state_dict(),
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
    return models, jax_reflect_padded_scores(root, TASK, "net_pir.pth")


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
        work = tmp_path_factory.mktemp(f"spatial_pir{world}")
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
def test_sharded_prompt_block_equals_whole_block(spawned, world):
    """A PromptGenBlock on each rank's slab (its mean's sums summed over
    the ranks, the prompt's rows of the whole image's resize) against the
    block on the whole (padded) image."""
    inp, runs = spawned[:2]
    blk = inp["block"]
    gen = PromptGenBlock(*blk["args"])
    gen.load_state_dict(blk["state"])
    with torch.no_grad():
        want = gen(_padded(blk["x"], BLOCK_UNIT))
    assert_close(runs[world][0]["block"], want, atol=ATOL, rtol=0)
    assert want.abs().max() > 0.1


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_sharded_model_equals_unsharded_port(spawned, unsharded, world,
                                             name):
    h = MODEL_CASES[name][0]
    got = spawned[1][world][0]["model"][name]
    assert got.shape[1] % 32 == 0
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
    """The prompt resized to the slab's height, or the mean's sums left
    unsummed over the ranks, must miss the bound the sharded forward
    meets."""
    got = spawned[1][world][0]["planted"][plant][
        :, : MODEL_CASES["uneven"][0]]
    err = (got - unsharded["uneven"]).abs().max().item()
    assert err > 100 * ATOL, f"{plant}: {err}"


def test_one_rank_shard_equals_unsharded():
    """A one-rank layout runs every sharded module with no neighbours:
    equal to the unsharded forward but for the PromptGenBlocks' means, its
    float32 sums over the pixel count where `x.mean` rounds its own way
    (an ulp of the mean, which the softmax over the prompt banks carries
    on to a few 1e-6 of the output)."""
    m = _model(7)
    rng = np.random.default_rng(7)
    lq, ref = t(rng.random((1, 40, 36, 3), np.float32)), t(
        rng.random((1, 32, 32, 3), np.float32))
    s = RowShard.split(40, m.row_unit, 0, 1)
    with torch.no_grad():
        want = m(lq, ref)
        got = m(s.slab(lq), ref, shard=s)
    assert_close(got[:, :40], want, atol=2e-5, rtol=0)


def test_shard_refusals():
    m = _model(0)
    s = RowShard.split(64, m.row_unit, 0, 1)
    lq, ref = torch.rand(1, 64, 32, 3), torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="slab of 40 rows"):
        m(lq[:, :40], ref, shard=s)
    x = torch.rand(1, 8, 8, 384, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        m.noise_level3(x, RowShard.split(8, 4, 0, 1))
    chained = define_network({**OPT, "num_blocks": [2, 1, 1, 1],
                              "chain": True})
    with pytest.raises(ValueError, match="chain"), torch.no_grad():
        chained.encoder_level1(torch.rand(1, 32, 8, 8),
                               RowShard.split(32, 32, 0, 1))


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
