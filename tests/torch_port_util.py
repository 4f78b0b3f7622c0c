"""Helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and fed to both the JAX function and
its port counterpart.  JAX parameters are built by converting the port
module's state dict with the JAX package's own `convert_state_dict`, never
with `model.init` (slow un-jitted on CPU).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch



@pytest.fixture
def torch_share_of_cores():
    """torch's intra-op threads cut to this process's share of the cores
    for a test that runs torch alone, then restored.  The suite runs
    several test processes at once (pytest-xdist), and torch's default of
    one thread per core in each oversubscribes the host, slowing small ops
    many times over.  Never around JAX work: XLA's CPU convolutions share
    the OpenMP thread count, and at one thread they lost f32 accuracy
    (2e-4 relative on a tiny train step's loss)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def randomize(module: torch.nn.Module, seed: int, scale: float = 0.05):
    """Overwrite every parameter with seeded N(0, scale^2) values (numpy),
    so zero-initialised gates and unit temperatures are exercised too."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(t(randn(rng, *p.shape, scale=scale)))
    return module


def jax_tree(module: torch.nn.Module, name: str) -> dict:
    """The JAX parameter tree of `module` when it sits at attribute `name`
    of a reference network (the key rewrite depends on that name)."""
    from textualdegremoval_tpu.convert import convert_state_dict

    holder = torch.nn.Module()
    setattr(holder, name, module)
    return convert_state_dict(holder.state_dict())[name]


def assert_close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "textualdegremoval_tpu_torch" / "csrc"


def build_host_library(out_dir: Path,
                       sources: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The csrc/*.cu `sources` (default: all) compiled for the CPU against
    tests/cuda_host_shim.h (one std::thread per CUDA thread; blocks run one
    after the other) and linked into one library with the C signatures of
    the CUDA build that it defines.  Skips the calling test when g++ is
    missing."""
    from textualdegremoval_tpu_torch.ops._build import _SIGNATURES

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found; the host build of the CUDA sources "
                    "needs it")
    procs, objs = [], []
    for cu in sorted(CSRC.glob("*.cu")):
        if sources is not None and cu.name not in sources:
            continue
        src = cu.read_text()
        src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                         r"shim_launch(\2, \1, ", src, flags=re.S)
        assert n >= 1, f"no kernel launch found in {cu.name}"
        cpp = out_dir / f"{cu.stem}_host.cpp"
        cpp.write_text('#include "cuda_host_shim.h"\n' + src)
        obj = out_dir / f"{cu.stem}_host.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [gxx, "-O2", "-std=c++20", "-fPIC", "-pthread",
             "-fno-strict-aliasing", f"-I{TESTS}", f"-I{CSRC}", "-c", "-o",
             str(obj), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    so = out_dir / "libtblock_host.so"
    res = subprocess.run([gxx, "-shared", "-pthread", "-o", str(so),
                          *map(str, objs)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
    return lib


def jax_tower_tree(module: torch.nn.Module, tower: str) -> dict:
    """The JAX parameter tree of a pipeline A tower of the port, made by the
    JAX package's own tower_maps converters from the port module's
    reference-format state dict (the UNet's global K/V passed as the
    mapper artifact carries them)."""
    from textualdegremoval_tpu.convert import tower_maps as tm
    from textualdegremoval_tpu_torch.convert import (
        mapper_reference_state_dict,
    )

    sd = module.state_dict()
    if tower == "text_encoder":
        return tm.convert_clip_text(sd)
    if tower == "image_encoder":
        return tm.convert_clip_vision(sd)
    if tower == "vae":
        enc = module.encoder.down_blocks
        return tm.convert_vae(sd, n_down=len(enc),
                              layers_per_block=len(enc[0].resnets))
    if tower == "unet":
        plain = {k: v for k, v in sd.items() if "_global" not in k}
        artifact = {re.sub(r"\.to_([kv])_global\.weight$", r"_to_\1.weight",
                           k): v for k, v in sd.items() if "_global" in k}
        return tm.convert_unet(
            plain, n_blocks=len(module.down_blocks),
            layers_per_block=len(module.down_blocks[0].resnets),
            global_kv=tm.extract_global_kv(artifact))
    return tm.convert_mapper(mapper_reference_state_dict(module),
                             module.num_words,
                             with_patch=hasattr(module, "mapping_patch"))


def tiny_guidance_modules(seed: int = 0, num_words: int = 4,
                          dtype: torch.dtype = torch.float32):
    """The port's small_test_config towers with seeded weights at a
    working scale (every tensor non-zero, so that each reaches the output)
    and the JAX package's modules of the same config with the same
    parameters: (port GuidanceModules, JAX GuidanceModules, JAX params)."""
    from textualdegremoval_tpu.diffusion.pipeline import (
        GuidanceModules as JaxGuidanceModules,
    )
    from textualdegremoval_tpu_torch.diffusion.pipeline import GuidanceModules

    mods = GuidanceModules.small_test_config(num_words=num_words, dtype=dtype)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in mods.towers().values():
            for name, p in mod.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.endswith("_kernel"):  # stacked (W, in, out)
                    p.copy_(t(randn(rng, *p.shape, scale=p.shape[1] ** -0.5)))
                elif leaf == "weight" and p.dim() >= 2:  # N(0, 1/fan_in)
                    p.copy_(t(randn(rng, *p.shape,
                                    scale=p[0].numel() ** -0.5)))
                elif leaf.endswith("weight"):  # norm scales near 1
                    p.copy_(t(1 + randn(rng, *p.shape, scale=0.1)))
                else:  # biases, the class embedding
                    p.copy_(t(randn(rng, *p.shape, scale=0.1)))
            mod.eval()
    jmods = JaxGuidanceModules.small_test_config(num_words=num_words)
    if dtype != torch.float32:
        import dataclasses

        import jax.numpy as jnp

        jdt = {torch.bfloat16: jnp.bfloat16}[dtype]
        jmods = dataclasses.replace(jmods, **{
            name: getattr(jmods, name).clone(dtype=jdt)
            for name in ("text_encoder", "image_encoder", "unet", "vae")})
    params = {name: jax_tower_tree(mod, name)
              for name, mod in mods.towers().items()}
    return mods, jmods, params
