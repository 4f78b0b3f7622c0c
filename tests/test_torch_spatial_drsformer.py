"""The row-sharded DRSformerRefFusion (the evaluate CLI's --spatial_shard on
`drsformer_derain` and `drsformer_derain_200l_spa`) against the unsharded
port and JAX, on the CPU: each world of ranks is spawned once
(tests/torch_dist_worker.py case `spatial_pools`, gloo) and its results
read by the tests below.

Each stencil chain reads its neighbours' rows once, none past the image's
true edges, and crops its reach off: TKSA's 3x3 on a 1-row halo, MSFN's
two 5x5 stages on 4 rows of the block's input, each MEFC step on 6 (its
7x7 separable and dilated convs, its 3x3 pool without the padding).
TKSA's raw gram and square sums and MEFC's routing mean take the slab's
own rows, summed over the ranks; the top-k masks run on the summed gram.
JAX's bound for its sharded forward, atol 1e-4, holds the port's here
against its unsharded forward and against JAX's `model.apply`.  The tiny
networks of `--tiny_debug` (dim 8, lr_block_size 4: units of 32 rows, 4
at the latent, MSFN's whole halo) with and without MEFC, at heights that
are not multiples of the unit: 3 units shared 2 + 1 and 1 + 1 + 1, and 2
units shared 1 + 1 + 0 (a rank with no rows).  Weights at a trained
network's scale with TKSA's four blend weights in [0.2, 0.5], so that
each planted fault misses the bound: the masks taken from the rank's own
gram before the reduce, MEFC on a 3-row halo, and a rank without rows
whose sums count.  The CLI: two ranks on images of odd height for both
tasks against JAX's `model.apply` on the reflect-padded input (the
uneven case's shapes, whose JAX compiles it reuses), and JAX's CLI
--spatial_shard 2 in a process of its own, started first so that it runs
beside the ranks.  `spawn_worlds` and its helpers serve
tests/test_torch_spatial_sfnet.py too."""

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
from torch_port_util import (  # noqa: F401  (a fixture)
    assert_close, randn, t, torch_share, torch_share_of_cores,
)

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, shrink_for_smoke,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models.drsformer import (
    MEFC, SparseTransformerBlock,
)
from textualdegremoval_tpu_torch.parallel.spatial import RowShard

TASK, SPA_TASK = "drsformer_derain", "drsformer_derain_200l_spa"
# every task's --tiny_debug network options
OPTS = {task: shrink_for_smoke(dict(opt)) for task, opt in TASK_TABLE.items()}
ATOL = 1e-4  # JAX's own bound, sharded against unsharded
MODEL_CASES = {  # name: (task, lq height, width)
    "uneven": (TASK, 70, 40),  # 3 units: 2 + 1 on two ranks, 1 + 1 + 1
    "empty": (TASK, 40, 36),   # 2 units: 1 + 1 + 0 on three ranks
    "uneven_spa": (SPA_TASK, 70, 40),
    "empty_spa": (SPA_TASK, 40, 36),
}
PLANTS = {2: [("tksa_before_reduce", "uneven"), ("mefc_halo_3", "uneven")],
          3: [("tksa_before_reduce", "uneven"), ("mefc_halo_3", "uneven"),
              ("empty_counted", "empty")]}
# single modules on a slab: a sparse block (MSFN's 4-row halo) in units
# of 4 rows, 4 units: 2 + 2 and 2 + 1 + 1; MEFC (6 rows) in units of 8, 3
# units: 2 + 1 and 1 + 1 + 1
BLOCKS = (("SparseTransformerBlock", (16, 2), (13, 9), 4),
          ("MEFC", (8,), (20, 9), 8))
# the CLI's images, by task: reflect-padded to 70 and 40 rows, a JAX case's
# shapes, whose compile the CLI's comparison reuses
CLI_HW = {TASK: (69, 40), SPA_TASK: (39, 36)}
# the cases held against JAX's `model.apply`, one compile a task (the
# others against the unsharded port only)
JAX_CASES = ("uneven", "empty_spa")


def drs_scale(module: torch.nn.Module, seed: int):
    """`trained_scale`, then TKSA's blend weights in [0.2, 0.5]: each of
    the four masked softmaxes moves the output."""
    trained_scale(module, seed)
    rng = np.random.default_rng(seed + 1000)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("attn1", "attn2", "attn3", "attn4")):
                p.copy_(t(0.2 + 0.3 * rng.random(p.shape, np.float32)))
    return module


def _model(task, seed):
    return drs_scale(define_network(dict(OPTS[task])), seed).eval()


def model_inputs(cases, make, seed, ramp=0.0):
    """Each case's options, weights (`make(task, i)`), lq and a 32 x 40
    reference; lq uniform, or with `ramp` of it a ramp down the rows (each
    region of the image then has a mean of its own)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, (task, h, w)) in enumerate(cases.items()):
        rows = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
        lq = (1 - ramp) * rng.random((1, h, w, 3), np.float32) + ramp * rows
        out[name] = {"opt": OPTS[task], "state": make(task, i).state_dict(),
                     "lq": t(lq.astype(np.float32)),
                     "ref": t(rng.random((1, 32, 40, 3), np.float32))}
    return out


def jax_task(task, names, inp, root):
    """JAX's `model.apply` of the named model cases, of `task` (a list for
    SFNet), then `jax_reflect_padded_scores` of root's CLI folder, whose
    shapes are a case's, so that its compile serves both: (forwards by
    case, scores)."""
    import jax.numpy as jnp

    from textualdegremoval_tpu.convert import convert_state_dict
    from textualdegremoval_tpu.convert.torch_to_jax import split_batch_stats

    out = {}
    for name in names:
        case = inp["models"][name]
        y = jax_apply(task)(
            split_batch_stats(convert_state_dict(case["state"])),
            jnp.asarray(case["lq"].numpy()), jnp.asarray(case["ref"].numpy()))
        out[name] = ([np.asarray(a) for a in y] if isinstance(y, list)
                     else np.asarray(y))
    return out, jax_reflect_padded_scores(root, task, "net.pth")


def spawn_worlds(tmp_path_factory, tag, inp, cases, jax_cases, roots,
                 jax_cli_task):
    """JAX's sharded CLI on roots[jax_cli_task] started first and
    `jax_task` of each task (its cases among jax_cases, its CLI folder
    roots[task]) in a thread of its own, then each world's ranks once;
    (inputs, {world: rank outputs}, JAX CLI's process, (JAX's forward of
    each of jax_cases, JAX's scores by task)).  One JAX compile a task:
    a task's CLI images are reflect-padded to its case's shapes."""
    jax_cli = start_jax_sharded_cli(cli_argv(
        roots[jax_cli_task], jax_cli_task, "net.pth", "--spatial_shard",
        "2"))
    pool = ThreadPoolExecutor(len(roots))
    jobs = [pool.submit(jax_task, task, [n for n in jax_cases
                                         if cases[n][0] == task], inp, root)
            for task, root in roots.items()]
    runs = {}
    for world in (2, 3):
        work = tmp_path_factory.mktemp(f"{tag}{world}")
        torch.save(inp, work / "input.pt")
        runs[world] = dw.spawn("spatial_pools", work, world)
    pool.shutdown()
    models, scores = {}, {}
    for task, job in zip(roots, jobs):
        models.update(job.result()[0])
        scores[task] = job.result()[1]
    return inp, runs, jax_cli, (models, scores)


def unsharded_forwards(inp):
    """The port's unsharded forward of each model case (torch alone: its
    share of the cores, `torch_share`)."""
    out = {}
    with torch_share():
        for name, case in inp["models"].items():
            m = define_network(dict(case["opt"]))
            m.load_state_dict(case["state"])
            with torch.no_grad():
                out[name] = m.eval()(case["lq"], case["ref"])
    return out


def make_eval_dirs(tmp_path_factory, tag, cli_hw, make, seed):
    """A CLI folder for each task of cli_hw (task: image height, width):
    its images (`write_eval_images`) and net.pth of `make(task, i)`'s
    weights.  Returns {task: folder}."""
    roots = {}
    for i, (task, hw) in enumerate(cli_hw.items()):
        roots[task] = tmp_path_factory.mktemp(f"{tag}_{i}")
        write_eval_images(roots[task], hw, seed + i)
        torch.save({"params": make(task, 9 + i).state_dict()},
                   roots[task] / "net.pth")
    return roots


def padded(img, unit):
    h = img.shape[1]
    return torch.nn.functional.pad(img, (0, 0, 0, 0, 0, (-h) % unit))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    return make_eval_dirs(tmp_path_factory, "spatial_drs_cli", CLI_HW,
                          _model, 31)


def _argv(roots, task, *extra):
    return cli_argv(roots[task], task, "net.pth", *extra)


def _block(module, args, seed):
    cls = {"SparseTransformerBlock": SparseTransformerBlock,
           "MEFC": MEFC}[module]
    return drs_scale(cls(*args), seed).eval()


def _inputs(roots):
    rng = np.random.default_rng(19)
    blocks = []
    for i, (module, args, hw, unit) in enumerate(BLOCKS):
        blocks.append({"module": module, "args": args, "unit": unit,
                       "state": _block(module, args, 40 + i).state_dict(),
                       "x": t(randn(rng, 1, *hw, args[0]))})
    return {"blocks": blocks, "models": model_inputs(MODEL_CASES, _model, 23),
            "plants": PLANTS,
            "argvs": {2: [_argv(roots, task, "--spatial_shard", "2")
                          for task in CLI_HW]}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, eval_dirs):
    return spawn_worlds(tmp_path_factory, "spatial_drs", _inputs(eval_dirs),
                        MODEL_CASES, JAX_CASES, eval_dirs, TASK)


@pytest.fixture(scope="module")
def unsharded(spawned):
    return unsharded_forwards(spawned[0])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("i", range(len(BLOCKS)),
                         ids=[b[0] for b in BLOCKS])
def test_sharded_module_equals_whole_module(spawned, world, i,
                                           torch_share_of_cores):
    """A sparse block and MEFC on each rank's slab with their halos and
    reduced statistics, against the module on the whole (padded) input."""
    inp, runs = spawned[:2]
    blk = inp["blocks"][i]
    m = _block(blk["module"], blk["args"], 0)
    m.load_state_dict(blk["state"])
    x = padded(blk["x"], blk["unit"])
    with torch.no_grad():
        want = m(x)
    assert_close(runs[world][0]["blocks"][i], want, atol=ATOL, rtol=0)
    assert (want - x).abs().max() > 0.1


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_sharded_model_equals_unsharded_port(spawned, unsharded, world,
                                             name):
    h = MODEL_CASES[name][1]
    got = spawned[1][world][0]["model"][name]
    assert got.shape[1] % 32 == 0
    assert_close(got[:, :h], unsharded[name], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_model_equals_jax(spawned, name):
    """The three-rank forward against JAX's `model.apply` on the same
    input and weights."""
    want = spawned[3][0][name]
    got = spawned[1][3][0]["model"][name][:, : MODEL_CASES[name][1]]
    assert got.shape == want.shape
    assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("world,plant,name", [
    (w, p, n) for w, plants in PLANTS.items() for p, n in plants])
def test_planted_faults_fail_the_bound(spawned, unsharded, world, plant,
                                       name):
    """TKSA's masks taken before the reduce, MEFC on a 3-row halo, or a
    rank without rows whose sums count, must miss the bound the sharded
    forward meets."""
    got = spawned[1][world][0]["planted"][plant][:, : MODEL_CASES[name][1]]
    err = (got - unsharded[name]).abs().max().item()
    assert err > 100 * ATOL, f"{plant}: {err}"


@pytest.mark.parametrize("task", [TASK, SPA_TASK])
def test_one_rank_shard_equals_unsharded(task, torch_share_of_cores):
    """A one-rank layout runs every sharded module with no neighbours:
    equal to the unsharded forward but for TKSA's gram, normalised after
    its sums where F.normalize normalises q and k first, and the means'
    float32 sums over the pixel count: a few float32 ulps of the gram,
    carried on to a few 1e-6 of the output."""
    m = _model(task, 7)
    rng = np.random.default_rng(7)
    lq, ref = t(rng.random((1, 40, 36, 3), np.float32)), t(
        rng.random((1, 32, 32, 3), np.float32))
    s = RowShard.split(40, m.row_unit, 0, 1)
    with torch.no_grad():
        want = m(lq, ref)
        got = m(s.slab(lq), ref, shard=s)
    assert_close(got[:, :40], want, atol=2e-5, rtol=0)


def test_shard_refusals(torch_share_of_cores):
    m = _model(TASK, 0)
    s = RowShard.split(64, m.row_unit, 0, 1)
    lq, ref = torch.rand(1, 64, 32, 3), torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="slab of 40 rows"):
        m(lq[:, :40], ref, shard=s)
    x = torch.rand(1, 8, 8, 16)
    with pytest.raises(ValueError, match="halo of 4 rows exceeds the 2-row"), \
            torch.no_grad():
        _block("SparseTransformerBlock", (16, 2), 0)(
            x, RowShard.split(8, 2, 0, 1))
    with pytest.raises(ValueError, match="MEFC: a halo of 6 rows"), \
            torch.no_grad():
        _block("MEFC", (16,), 0)(x, RowShard.split(8, 4, 0, 1))


@pytest.mark.parametrize("i,task", enumerate(CLI_HW))
def test_sharded_cli_equals_jax_on_reflect_padded_input(spawned, i, task):
    """Rank 0 scores (rank 1 returns None) what JAX's `model.apply` scores
    on the reflect-padded input (`jax_reflect_padded_scores`)."""
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

    assert main(_argv(eval_dirs, SPA_TASK, "--spatial_shard", "1")) == \
        main(_argv(eval_dirs, SPA_TASK))
