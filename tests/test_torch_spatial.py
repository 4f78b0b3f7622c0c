"""The row-sharded forward of the port (parallel/spatial.py, the blocks'
and RestormerRefFusion's `shard`) against the unsharded port and JAX, on
the CPU: each world of ranks is spawned once (tests/torch_dist_worker.py
case `spatial`, gloo) and its results read by the tests below.

JAX's `--spatial_shard` (textualdegremoval_tpu/cli/evaluate.py:176-190)
leaves the halo exchanges to GSPMD, and tests/test_spatial_sharding.py
(slow) holds its sharded forward equal to the unsharded one at atol 1e-4:
the same bound holds the port's sharded forward here, against the port's
unsharded forward and against JAX's `model.apply`.  The layouts: heights
that are not multiples of the row unit times the ranks, shares 2 + 1 and
1 + 1 + 1 of 32-row units (tiny lr_block_size 4), and 1 + 1 + 0, a rank
with no rows.  Weights at a trained network's scale, so that each block
adds O(1) and both planted faults (a 1-row block halo, statistics not
summed over the ranks) miss the bound by orders of magnitude."""

import numpy as np
import pytest
import torch

import torch_dist_worker as dw
from torch_port_util import assert_close, randn, t

from textualdegremoval_tpu_torch.models.restormer import RestormerRefFusion
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.parallel.spatial import (
    RowShard, exchange_rows, gather_rows, halo_rows, reduce_stats,
)

TINY_REF = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                heads=(1, 1, 2, 2), nf=8, ext_n_blocks=(1, 1, 1, 1),
                reffusion_n_blocks=(1, 1, 1, 1), lr_block_size=4)
ATOL = 1e-4  # JAX's own bound, sharded against unsharded
MODEL_CASES = {  # name: (lq height, width, network options)
    "uneven": (70, 44, {}),   # 3 units: 2 + 1 on two ranks, 1 + 1 + 1 on 3
    "empty": (40, 36, {}),    # 2 units: 1 + 1 + 0 on three ranks
    "dual": (70, 44, dict(inp_channels=6, dual_pixel_task=True)),
}
# 3 units of 4 rows: 2 + 1 and 1 + 1 + 1; 2 units: 1 + 1 and 1 + 1 + 0
LAYOUT_HEIGHTS, LAYOUT_W, LAYOUT_UNIT = (10, 6), 5, 4
BLOCK_HW, BLOCK_UNIT = (13, 9), 4    # 4 units: 2 + 2, and 2 + 1 + 1


def trained_scale(module: torch.nn.Module, seed: int):
    """Seeded weights at a trained network's scale: matrices and conv
    kernels N(0, 1/fan_in), LayerNorm weights 1 + N(0, 0.1^2), fusion
    gates in [0.25, 0.75], temperatures in [0.5, 1.5], the rest
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("temperature"):
                v = 0.5 + rng.random(p.shape, np.float32)
            elif p.dim() > 1:
                v = randn(rng, *p.shape, scale=p[0].numel() ** -0.5)
            elif name.endswith("alpha"):
                v = 0.25 + 0.5 * rng.random(p.shape, np.float32)
            else:
                v = randn(rng, *p.shape, scale=0.1)
                if name.endswith("weight"):
                    v = v + 1.0
            p.copy_(t(v))
    return module


def _model(kw, seed=0):
    return trained_scale(RestormerRefFusion(**TINY_REF, **kw), seed).eval()


def _inputs():
    rng = np.random.default_rng(5)
    models = {}
    for i, (name, (h, w, kw)) in enumerate(MODEL_CASES.items()):
        m = _model(kw, seed=i)
        models[name] = {
            "kw": {**TINY_REF, **kw}, "state": m.state_dict(),
            "lq": t(rng.random((1, h, w, kw.get("inp_channels", 3)),
                               np.float32)),
            "ref": t(rng.random((1, 48, 40, 3), np.float32))}
    blk = _model({}).encoder_level3[0]  # 32 channels, 2 heads
    return {
        "layout_imgs": [t(randn(rng, 1, h, LAYOUT_W, 3)) + 10.0
                        for h in LAYOUT_HEIGHTS],
        "layout_unit": LAYOUT_UNIT,
        "block_x": t(randn(rng, 1, *BLOCK_HW, 32)),
        "block": {"p": {k: v.detach() for k, v in blk.block_params().items()},
                  "heads": 2, "ln_type": "WithBias", "unit": BLOCK_UNIT},
        "models": models}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Each world's ranks run once; (inputs, {world: rank outputs})."""
    inp = _inputs()
    runs = {}
    for world in (2, 3):
        work = tmp_path_factory.mktemp(f"spatial{world}")
        torch.save(inp, work / "input.pt")
        runs[world] = dw.spawn("spatial", work, world)
    return inp, runs


def _padded(img, unit):
    h = img.shape[1]
    return torch.nn.functional.pad(img, (0, 0, 0, 0, 0, (-h) % unit))


@pytest.fixture(scope="module")
def unsharded(spawned):
    """The port's unsharded forward of each model case."""
    inp, _ = spawned
    out = {}
    for name, case in inp["models"].items():
        m = RestormerRefFusion(**case["kw"])
        m.load_state_dict(case["state"])
        with torch.no_grad():
            out[name] = m.eval()(case["lq"], case["ref"])
    return out


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("height,unit,world,rows_of", [
    (70, 32, 2, (64, 32)),        # uneven: the first rank takes the extra
    (96, 32, 3, (32, 32, 32)),
    (40, 32, 3, (32, 32, 0)),     # a rank with no rows
    (5, 8, 4, (8, 0, 0, 0)),
])
def test_row_shard_split_shares_whole_units(height, unit, world, rows_of):
    shards = [RowShard.split(height, unit, r, world) for r in range(world)]
    assert all(s.rows_of == rows_of for s in shards)
    assert shards[0].height == -(-height // unit) * unit
    assert [s.start for s in shards] == list(np.cumsum((0,) + rows_of[:-1]))
    for r, s in enumerate(shards):
        assert s.local == (rows_of[r] or unit)
        assert s.up == (r - 1 if rows_of[r] and r else None)
        has_down = rows_of[r] and r + 1 < world and rows_of[r + 1]
        assert s.down == (r + 1 if has_down else None)


def test_row_shard_scales_and_slabs():
    s = RowShard.split(70, 32, 1, 2)
    half = s.scaled(8)
    assert (half.height, half.rows_of, half.unit, half.start) == \
        (12, (8, 4), 4, 8)
    img = torch.arange(70.0).reshape(1, 70, 1, 1)
    assert torch.equal(s.slab(img)[0, :, 0, 0],
                       torch.cat([torch.arange(64.0, 70.0), torch.zeros(26)]))
    empty = RowShard.split(40, 32, 2, 3)
    assert empty.slab(img[:, :40]).shape == (1, 32, 1, 1)
    assert not empty.slab(img[:, :40]).any()
    with pytest.raises(ValueError, match="scale"):
        RowShard.split(70, 4, 0, 2).scaled(8)


def test_one_rank_collectives_are_local():
    """A one-rank layout (no process group): zero rows past both edges,
    nothing to sum, the slab its own whole image."""
    s = RowShard.split(6, 2, 0, 1)
    x = torch.rand(1, 6, 3, 2)
    ext = exchange_rows(x, 2, s)
    assert torch.equal(ext[:, 2:8], x) and not ext[:, :2].any() \
        and not ext[:, 8:].any()
    assert torch.equal(halo_rows(x, 2, s)[0], x)
    a = torch.ones(3)
    assert reduce_stats(a, shard=s)[0] is a and torch.equal(a, torch.ones(3))
    assert torch.equal(gather_rows(x, s), x)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("layout", range(len(LAYOUT_HEIGHTS)))
def test_exchange_rows_from_neighbours_zeros_at_true_edges(spawned, world,
                                                          layout):
    inp, runs = spawned
    img = _padded(inp["layout_imgs"][layout], LAYOUT_UNIT)
    zero = torch.zeros_like(img[:, :2])
    pad = torch.cat([zero, img, zero], dim=1)  # rows -2 .. h + 1
    for r, out in enumerate(runs[world]):
        lay = out["layout"][layout]
        if lay["rows_of"][r] == 0:  # no rows: a unit of zeros, read by none
            assert lay["up"] is None and lay["down"] is None
            assert lay["ext"].shape[1] == LAYOUT_UNIT + 4
            assert not lay["ext"].any()
            continue
        s, n = lay["start"], lay["local"]
        assert torch.equal(lay["ext"], pad[:, s: s + n + 4]), f"rank {r}"


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("layout", range(len(LAYOUT_HEIGHTS)))
def test_reduce_stats_sums_and_gather_rows_on_rank0(spawned, world, layout):
    inp, runs = spawned
    img = _padded(inp["layout_imgs"][layout], LAYOUT_UNIT)
    for r, out in enumerate(runs[world]):
        lay = out["layout"][layout]
        assert torch.equal(lay["stat"], torch.full(
            (3,), float(world * (world + 1) // 2)))
        if r == 0:
            assert torch.equal(lay["whole"], img)
        else:
            assert lay["whole"] is None
        tr = lay["trace"]
        assert (tr["exchanges"], tr["reduces"], tr["gathers"]) == (1, 1, 1)
        # each rank's first and last 2 rows from every other rank
        assert tr["exchange_bytes"] == 4 * LAYOUT_W * 3 * 4 * (world - 1)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_block_equals_whole_block(spawned, world):
    """`tblock_ref` on each rank's slab with its 2-row halo and the
    statistics summed over the ranks, against the block on the whole
    (padded) image."""
    inp, runs = spawned
    x = _padded(inp["block_x"], BLOCK_UNIT)
    blk = inp["block"]
    with torch.no_grad():
        want = tb.tblock_ref(x, blk["p"], blk["heads"], blk["ln_type"])
    assert_close(runs[world][0]["block"], want, atol=ATOL, rtol=0)
    assert (want - x).abs().max() > 0.1  # the block adds O(1)


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
    input and weights (the uneven and empty cases on three ranks)."""
    import jax
    import jax.numpy as jnp

    from textualdegremoval_tpu.convert import convert_state_dict
    from textualdegremoval_tpu.models.restormer import (
        RestormerRefFusion as JRestormerRefFusion)

    inp, runs = spawned
    case = inp["models"][name]
    kw = MODEL_CASES[name][2]
    params = {"params": convert_state_dict(case["state"])}
    want = jax.jit(JRestormerRefFusion(**TINY_REF, **kw).apply)(
        params, jnp.asarray(case["lq"].numpy()),
        jnp.asarray(case["ref"].numpy()))
    got = runs[3][0]["model"][name][:, : case["lq"].shape[1]]
    assert got.shape == want.shape
    assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("plant", ["halo_1", "unreduced"])
def test_planted_faults_fail_the_bound(spawned, unsharded, world, plant):
    """A 1-row block halo (the GDFN stencil then reads an x1 row made
    from a zero-padded q | k | v), or each rank's statistics left unsummed,
    must miss the bound the sharded forward meets."""
    name = next(iter(MODEL_CASES))
    got = spawned[1][world][0]["planted"][plant][:, : MODEL_CASES[name][0]]
    err = (got - unsharded[name]).abs().max().item()
    assert err > 100 * ATOL, f"{plant}: {err}"


def test_one_rank_shard_equals_unsharded():
    """A one-rank layout runs every sharded module with no neighbours:
    equal to the unsharded forward bit for bit."""
    m = _model({})
    rng = np.random.default_rng(7)
    lq, ref = t(rng.random((1, 40, 36, 3), np.float32)), t(
        rng.random((1, 32, 32, 3), np.float32))
    s = RowShard.split(40, m.row_unit, 0, 1)
    with torch.no_grad():
        want = m(lq, ref)
        got = m(s.slab(lq), ref, shard=s)
    assert torch.equal(got[:, :40], want)


def test_shard_refusals():
    m = _model({})
    s = RowShard.split(64, m.row_unit, 0, 1)
    lq, ref = torch.rand(1, 64, 32, 3), torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="slab of 40 rows"):
        m(lq[:, :40], ref, shard=s)
    blk = m.encoder_level1[0]
    x = torch.rand(1, 8, 8, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        blk(x, RowShard.split(8, 4, 0, 1))
    chained = RestormerRefFusion(**{**TINY_REF, "num_blocks": (2, 1, 1, 1)},
                                 chain=True)
    with pytest.raises(ValueError, match="chain"), torch.no_grad():
        chained.encoder_level1(torch.rand(1, 32, 8, 8),
                               RowShard.split(32, 32, 0, 1))
    module_path = RestormerRefFusion(**TINY_REF, fused=False)
    with pytest.raises(ValueError, match="module path"), torch.no_grad():
        module_path.encoder_level1(torch.rand(1, 32, 8, 8),
                                   RowShard.split(32, 32, 0, 1))
