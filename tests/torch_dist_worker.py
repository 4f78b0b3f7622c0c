"""One rank of a multi-process CPU test of the port (gloo), and the
launcher the tests start ranks with.  Imports torch and the port only,
never JAX.

    python tests/torch_dist_worker.py CASE WORKDIR

with the torch launcher's env (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT): the rank joins through the port's `init_distributed`, reads
WORKDIR/input.pt, runs CASE on its share of the batch and writes
WORKDIR/out_<rank>.pt.  Cases:

* restormer_dp: one data-parallel step of make_train_step, then the same
  step from the same state with each planted reduce fault;
* fsdp: one step of make_train_step on a sharded state, then its
  checkpoint through CheckpointManager (rank 0 writes) and its restore;
* sfnet: one data-parallel train-mode step of SFNetRefFusion (BatchNorm
  over the global batch);
* guidance: micro-steps of make_guidance_train_step under MultiSteps on
  the tiny towers, each rank its own images;
* cli_restoration, cli_diffir, cli_i2t: the CLI's main on argv;
* spatial: the row-sharded forward (parallel/spatial.py): the layout, an
  exchange, a reduction and a gather; one block (`tblock_ref` with a
  shard); RestormerRefFusion on each input, and on the first with each
  planted fault (a 1-row block halo, statistics not reduced);
* spatial_family: the row-sharded NAFNetRefFusion or PromptIRRefFusion:
  one block (`nafblock_ref` with a shard, or a PromptGenBlock); the
  network on each input, and on one input with each planted fault of its
  pools (FAMILY_PLANTS); then the evaluate CLI's main on each argv;
* spatial_pools: the row-sharded DRSformerRefFusion or SFNetRefFusion:
  the sharded box mean and the reflect halo (parallel/spatial.py) on
  small images; single modules (a sparse block, MEFC, an SFResBlock with
  its dynamic filters, an SCM, a PatchAP) on a slab; the network on each
  input (SFNet's three scales each gathered at its layout), and with each
  planted fault (`pool_plants`) on the input it names for the world; then
  the evaluate CLI's main on each argv;
* cli_evaluate: the evaluate CLI's main on each argv in turn, a refusal
  (SystemExit) recorded as its message.
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# failure signatures that are environmental (a port taken between the
# probe and the bind, a slow rendezvous), not faults of the code: retried
RETRYABLE = ("Address already in use", "TIMEOUT waiting for rank",
             "Connection refused", "timed out", "EADDRINUSE")


def spawn(case: str, workdir, world: int = 2, timeout: float = 120,
          attempts: int = 3, extra_env: dict | None = None):
    """Run `world` ranks of CASE over a free local port (retried on a new
    port after an environmental failure); returns the ranks' outputs.
    Raises with every rank's output where a rank fails."""
    last = ""
    for _ in range(attempts):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for rank in range(world):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            env.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": str(rank),
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO),
                        **(extra_env or {})})
            procs.append(subprocess.Popen(
                [sys.executable, __file__, case, str(workdir)], env=env,
                cwd=str(workdir), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out = (out or "") + "\nTIMEOUT waiting for rank"
            outs.append(out)
        if all(p.returncode == 0 for p in procs):
            return [torch.load(Path(workdir) / f"out_{r}.pt",
                               weights_only=False) for r in range(world)]
        last = "\n---\n".join(f"rank {r} rc {p.returncode}:\n{o}"
                              for r, (p, o) in enumerate(zip(procs, outs)))
        if not any(sig in o for sig in RETRYABLE for o in outs):
            break
    raise RuntimeError(f"{case}: a rank failed\n{last}")


# -- the planted reduce faults (chip_smoke.py phase 38 plants the same) --

def reduce_without_division(tensors):
    """The sum over the ranks in place of the mean."""
    import torch.distributed as dist

    out = [t.detach().clone() for t in tensors]
    for t in out:
        dist.all_reduce(t)
    return out


def reduce_stale_copy(tensors):
    """Reduces a copy and hands back the rank's own gradients."""
    from textualdegremoval_tpu_torch.parallel.mesh import all_reduce_mean

    all_reduce_mean([t.detach().clone() for t in tensors])
    return list(tensors)


PLANTS = {"no_division": reduce_without_division,
          "stale_copy": reduce_stale_copy}


def _share(batch: dict, rank: int, world: int) -> dict:
    """This rank's equal share of a numpy batch, as tensors."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // world
        out[k] = torch.from_numpy(v[rank * n: (rank + 1) * n].copy())
    return out


def _restoration_state(inp: dict, ema_decay: float):
    from textualdegremoval_tpu_torch.models import define_network
    from textualdegremoval_tpu_torch.train import schedules
    from textualdegremoval_tpu_torch.train.trainer import (
        build_optimizer, create_train_state,
    )

    model = define_network(dict(inp["net"]))
    model.load_state_dict(inp["sd"])
    sched = inp.get("sched")
    lr = (schedules.build_schedule(2e-4, sched) if sched
          else (lambda s: 2e-4))
    ref_lr = (schedules.build_schedule(1e-4, sched) if sched
              else (lambda s: 1e-4))
    opt = build_optimizer(model, lr, ref_lr)
    return create_train_state(model, opt, ema_decay=ema_decay)


def _step_out(state, metrics) -> dict:
    return {"l_pix": float(metrics["l_pix"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()},
            "ema": {k: v.detach().clone()
                    for k, v in state.ema_state_dict().items()}}


def case_restormer_dp(inp, rank, world):
    from textualdegremoval_tpu_torch.losses import build_loss
    from textualdegremoval_tpu_torch.parallel import replicate
    from textualdegremoval_tpu_torch.train import trainer

    batch = _share(inp["batch"], rank, world)
    step = trainer.make_train_step(build_loss(inp["loss"]), ema_decay=0.9)
    state = replicate(_restoration_state(inp, 0.9))
    out = _step_out(*step(state, batch))
    out["plants"] = {}
    honest = trainer.all_reduce_mean
    for name, plant in PLANTS.items():
        trainer.all_reduce_mean = plant
        try:
            out["plants"][name] = _step_out(
                *step(_restoration_state(inp, 0.9), batch))
        finally:
            trainer.all_reduce_mean = honest
    return out


def case_fsdp(inp, rank, world):
    from textualdegremoval_tpu_torch.losses import build_loss
    from textualdegremoval_tpu_torch.parallel.fsdp import shard_train_state
    from textualdegremoval_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from textualdegremoval_tpu_torch.train.trainer import make_train_step

    batch = _share(inp["batch"], rank, world)
    state = shard_train_state(_restoration_state(inp, 0.9))
    step = make_train_step(build_loss(inp["loss"]), ema_decay=0.9)
    state, metrics = step(state, batch)
    ckpt = CheckpointManager("ckpt/states", "ckpt/models")
    ckpt.save_state(state, 1)
    ckpt.save_network(state, 1)
    # a fresh sharded state restored from it holds the same slices
    again = shard_train_state(_restoration_state(inp, 0.9))
    ckpt.restore_state(again)
    same = all(torch.equal(a, b) for a, b in zip(
        again.opt.params + again.opt.mu + again.opt.nu + again.ema,
        state.opt.params + state.opt.mu + state.opt.nu + state.ema))
    return {"l_pix": float(metrics["l_pix"]),
            "grad_norm": float(metrics["grad_norm"]),
            "dims": {lf.name: lf.dim for lf in state.leaves},
            "slices": dict(zip(state.opt.names,
                               (p.detach().clone()
                                for p in state.opt.params))),
            "mu": dict(zip(state.opt.names, state.opt.mu)),
            "ema": dict(zip(state.opt.names, state.ema)),
            "held": state.held_bytes(), "restored_equal": same,
            "restored_step": again.step}


def case_sfnet(inp, rank, world):
    from textualdegremoval_tpu_torch.losses import build_loss
    from textualdegremoval_tpu_torch.parallel import replicate
    from textualdegremoval_tpu_torch.train.trainer import make_train_step

    batch = _share(inp["batch"], rank, world)
    state = replicate(_restoration_state(inp, 0.0))
    state, metrics, grads = step_with_grads(
        make_train_step(build_loss(inp["loss"])), state, batch)
    return {**_step_out(state, metrics), "grads": grads}


def step_with_grads(step, state, batch):
    """(state, metrics, the gradients by name as the step hands them to
    the optimizer) of one step."""
    seen = {}
    update = state.opt.step

    def capture(gs):
        seen.update(zip(state.opt.names, (g.detach().clone() for g in gs)))
        update(gs)

    state.opt.step = capture
    state, metrics = step(state, batch)
    del state.opt.step
    return state, metrics, seen


def guidance_micro_steps(mods, opt, batches, generators):
    """make_guidance_train_step over `batches`, one generator each."""
    from textualdegremoval_tpu_torch.diffusion.pipeline import (
        make_guidance_train_step,
    )

    step = make_guidance_train_step(mods, opt, "i2t")
    return [float(step(b, g)) for b, g in zip(batches, generators)]


def tiny_guidance(k: int):
    """The tiny towers with seeded random weights and their optimizer
    under MultiSteps(k)."""
    from textualdegremoval_tpu_torch.cli.generate_reference import (
        random_init,
    )
    from textualdegremoval_tpu_torch.diffusion.pipeline import (
        GuidanceModules, make_guidance_optimizer,
    )

    mods = GuidanceModules.small_test_config(num_words=2)
    random_init(mods, torch.Generator().manual_seed(0))
    return mods, make_guidance_optimizer(mods, "i2t", lr=1e-3,
                                         accumulation_steps=k)


def case_guidance(inp, rank, world):
    from textualdegremoval_tpu_torch.diffusion.pipeline import partition

    mods, opt = tiny_guidance(inp["k"])
    per = inp["micro"]
    mine = inp["batches"][rank * per: (rank + 1) * per]
    gens = [torch.Generator().manual_seed(s)
            for s in inp["seeds"][rank * per: (rank + 1) * per]]
    losses = guidance_micro_steps(
        mods, opt, [{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in mine], gens)
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in partition(mods, "i2t")[0]}}


def case_cli_restoration(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import train_restoration

    state = train_restoration.main(inp["argv"])
    return {"step": state.step,
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}}


def case_cli_diffir(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import train_diffir

    state = train_diffir.main(inp["argv"])
    return {"step": state.step,
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}}


def case_cli_i2t(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import train_i2t
    from textualdegremoval_tpu_torch.diffusion.pipeline import partition

    mods = train_i2t.main(inp["argv"])
    return {"params": {n: p.detach().clone()
                       for n, p in partition(mods, "i2t")[0]}}


def case_spatial(inp, rank, world):
    from textualdegremoval_tpu_torch.models.restormer import (
        RestormerRefFusion)
    from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
    from textualdegremoval_tpu_torch.parallel.spatial import (
        CollectiveTrace, RowShard, exchange_rows, gather_rows, reduce_stats)

    out = {"layout": []}
    for img in inp["layout_imgs"]:
        trace = CollectiveTrace()
        shard = RowShard.split(img.shape[1], inp["layout_unit"], rank,
                               world, trace=trace)
        slab = shard.slab(img)
        stat = torch.full((3,), float(rank + 1))
        out["layout"].append({
            "rows_of": shard.rows_of, "start": shard.start,
            "local": shard.local, "up": shard.up, "down": shard.down,
            "ext": exchange_rows(slab, 2, shard),
            "stat": reduce_stats(stat, shard=shard)[0],
            "whole": gather_rows(slab, shard), "trace": trace.as_dict()})

    x, blk = inp["block_x"], inp["block"]
    shard = RowShard.split(x.shape[1], blk["unit"], rank, world)
    with torch.no_grad():
        y = tb.tblock_ref(shard.slab(x), blk["p"], blk["heads"],
                          blk["ln_type"], shard)
    out["block"] = gather_rows(y, shard)

    def forward(case):
        m = RestormerRefFusion(**case["kw"])
        m.load_state_dict(case["state"])
        m.eval()
        shard = RowShard.split(case["lq"].shape[1], m.row_unit, rank, world)
        with torch.no_grad():
            y = m(shard.slab(case["lq"]), case["ref"], shard=shard)
        return gather_rows(y, shard)

    out["model"] = {name: forward(case)
                    for name, case in inp["models"].items()}
    first = inp["models"][next(iter(inp["models"]))]
    plants = {"halo_1": ("BLOCK_HALO", 1),
              "unreduced": ("reduce_stats", lambda *t, shard: t)}
    out["planted"] = {}
    for name, (attr, value) in plants.items():
        kept = getattr(tb, attr)
        setattr(tb, attr, value)
        try:
            out["planted"][name] = forward(first)
        finally:
            setattr(tb, attr, kept)
    return out


def family_plants():
    """The planted faults of the sharded NAFBlock's SCA pool and the
    sharded PromptGenBlock (chip_smoke.py plants the SCA window's in the
    kernels): name -> (module, attribute, replacement)."""
    import torch.nn.functional as F

    from textualdegremoval_tpu_torch.models import promptir
    from textualdegremoval_tpu_torch.ops import bilinear_resize_torch
    from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb

    pool = nb.sca_pool

    def halo_counted(g, rows=None, reduce=None, pixels=None):
        """The SCA sums over the slab's halo rows too."""
        return pool(g, None if rows is None else (0, g.shape[1]), reduce,
                    pixels)

    def slab_divisor(g, rows=None, reduce=None, pixels=None):
        """The summed sums over the slab's H x W, not the image's."""
        return pool(g, rows, reduce,
                    None if pixels is None else g.shape[1] * g.shape[2])

    def slab_height(prompt, shard, w):
        """The prompt resized to the slab's height, not the image's."""
        return F.pad(bilinear_resize_torch(prompt, shard.local, w),
                     (0, 0, 0, 0, 1, 1))

    return {"halo_counted": (nb, "sca_pool", halo_counted),
            "slab_divisor": (nb, "sca_pool", slab_divisor),
            "prompt_slab_height": (promptir, "prompt_rows", slab_height),
            "prompt_unreduced": (promptir, "reduce_stats",
                                 lambda *t, shard: t)}


def case_spatial_family(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.models import define_network
    from textualdegremoval_tpu_torch.models.promptir import PromptGenBlock
    from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
    from textualdegremoval_tpu_torch.parallel.spatial import (
        RowShard, gather_rows)

    out = {}
    blk = inp["block"]
    shard = RowShard.split(blk["x"].shape[1], blk["unit"], rank, world)
    if "p" in blk:  # a NAFBlock's parameters
        def run(x):
            return nb.nafblock_ref(x, blk["p"], shard)
    else:
        run = PromptGenBlock(*blk["args"])
        run.load_state_dict(blk["state"])
        run = functools.partial(run, shard=shard)
    with torch.no_grad():
        out["block"] = gather_rows(run(shard.slab(blk["x"])), shard)

    def forward(case):
        m = define_network(dict(case["opt"]))
        m.load_state_dict(case["state"])
        m.eval()
        shard = RowShard.split(case["lq"].shape[1], m.row_unit, rank, world)
        with torch.no_grad():
            y = m(shard.slab(case["lq"]), case["ref"], shard=shard)
        return gather_rows(y, shard)

    out["model"] = {name: forward(case)
                    for name, case in inp["models"].items()}
    out["planted"] = {}
    plants = family_plants()
    for plant, name in inp["plants"]:
        module, attr, value = plants[plant]
        kept = getattr(module, attr)
        setattr(module, attr, value)
        try:
            out["planted"][plant] = forward(inp["models"][name])
        finally:
            setattr(module, attr, kept)
    out["cli"] = []
    for argv in inp.get("argvs", ()):
        try:
            out["cli"].append(evaluate.main(argv))
        except SystemExit as e:
            out["cli"].append(str(e))
    return out


def pool_plants():
    """The planted faults of the sharded DRSformer and SFNet: name ->
    [(owner, attribute, replacement)]."""
    from textualdegremoval_tpu_torch.models import drsformer, sfnet
    from textualdegremoval_tpu_torch.ops import attention as att
    from textualdegremoval_tpu_torch.parallel.spatial import RowShard

    def masked_before_reduce(q, k, v, temperature, blend, own=None,
                             reduce=None):
        """TKSA's masks from the rank's own gram, before the reduce."""
        sums = att.tksa_sums(*own)
        masks = att.tksa_masks(att.tksa_finish(*sums, temperature))
        reduce(*sums)
        attn = att.tksa_finish(*sums, temperature)
        return torch.matmul(att.tksa_blend(attn, blend, masks).to(v.dtype),
                            v)

    pool = sfnet._pool

    def slab_kernel(x, tlc_base, shard=None):
        """The TLC pool of the slab alone, its kernel from the slab's
        height."""
        return pool(x, tlc_base)

    def slab_unshuffle(x, p, tlc_base, shard):
        """PatchAP's view taken of the slab, not of the image."""
        b, n, ww, c = x.shape
        px = x.reshape(b, p, n // p, p, ww // p, c).permute(0, 2, 4, 5, 1, 3)
        px = px.reshape(b, n // p, ww // p, c * p * p)
        low = pool(px, tlc_base).expand_as(px)
        low = low.reshape(b, n // p, ww // p, c, p, p)
        return low.permute(0, 4, 1, 5, 2, 3).reshape(b, n, ww, c)

    return {
        "tksa_before_reduce": [(drsformer, "tksa_attention",
                                masked_before_reduce)],
        "mefc_halo_3": [(drsformer, "MEFC_HALO", 3)],
        "tlc_slab_height": [(sfnet, "_pool", slab_kernel)],
        "patch_slab_unshuffle": [(sfnet, "patch_pool", slab_unshuffle)],
        "empty_counted": [(RowShard, "own",
                           lambda self, x: x[:, : self.local])]}


def _gathered(y, shard):
    """gather_rows of a network's output, or of each of SFNet's scales,
    coarse to fine, at its layout."""
    from textualdegremoval_tpu_torch.parallel.spatial import gather_rows

    if isinstance(y, list):
        n = len(y)
        return [gather_rows(t, shard.scaled(2 ** (n - 1 - i)))
                for i, t in enumerate(y)]
    return gather_rows(y, shard)


def case_spatial_pools(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.models import (
        define_network, drsformer, sfnet)
    from textualdegremoval_tpu_torch.parallel.spatial import (
        RowShard, box_mean_rows, gather_rows, reflect_rows)

    out = {"box": [], "reflect": [], "blocks": []}
    for img, kernel, unit in inp.get("box", ()):
        shard = RowShard.split(img.shape[1], unit, rank, world)
        slab = shard.slab(img)
        out["box"].append(gather_rows(
            box_mean_rows(slab, kernel, shard).expand_as(slab), shard))
    for img, r, unit in inp.get("reflect", ()):
        shard = RowShard.split(img.shape[1], unit, rank, world)
        out["reflect"].append((shard.start, shard.rows, reflect_rows(
            shard.slab(img), r, shard)))
    for blk in inp.get("blocks", ()):
        cls = getattr(drsformer, blk["module"], None) or getattr(
            sfnet, blk["module"])
        m = cls(*blk["args"], **blk.get("kwargs", {}))
        m.load_state_dict(blk["state"])
        m.eval()
        shard = RowShard.split(blk["x"].shape[1], blk["unit"], rank, world)
        with torch.no_grad():
            out["blocks"].append(gather_rows(m(shard.slab(blk["x"]), shard),
                                             shard))

    def forward(case):
        m = define_network(dict(case["opt"]))
        m.load_state_dict(case["state"])
        m.eval()
        shard = RowShard.split(case["lq"].shape[1], m.row_unit, rank, world)
        with torch.no_grad():
            y = m(shard.slab(case["lq"]), case["ref"], shard=shard)
        return _gathered(y, shard)

    out["model"] = {name: forward(case)
                    for name, case in inp["models"].items()}
    out["planted"] = {}
    plants = pool_plants()
    for plant, name in inp["plants"].get(world, ()):
        kept = [(owner, attr, getattr(owner, attr))
                for owner, attr, _ in plants[plant]]
        for owner, attr, value in plants[plant]:
            setattr(owner, attr, value)
        try:
            out["planted"][plant] = forward(inp["models"][name])
        finally:
            for owner, attr, value in kept:
                setattr(owner, attr, value)
    out["cli"] = []
    for argv in inp.get("argvs", {}).get(world, ()):
        try:
            out["cli"].append(evaluate.main(argv))
        except SystemExit as e:
            out["cli"].append(str(e))
    return out


def case_cli_evaluate(inp, rank, world):
    from textualdegremoval_tpu_torch.cli import evaluate

    out = []
    for argv in inp["argvs"]:
        try:
            out.append(evaluate.main(argv))
        except SystemExit as e:
            out.append(str(e))
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(case: str, workdir: str) -> None:
    from textualdegremoval_tpu_torch.parallel import init_distributed

    torch.manual_seed(0)
    inp = torch.load(Path(workdir) / "input.pt", weights_only=False)
    rank, world = init_distributed("cpu")
    out = CASES[case](inp, rank, world)
    torch.save(out, Path(workdir) / f"out_{rank}.pt")
    if world > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
