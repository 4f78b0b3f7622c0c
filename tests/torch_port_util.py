"""Helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and fed to both the JAX function and
its port counterpart.  JAX parameters are built by converting the port
module's state dict with the JAX package's own `convert_state_dict`, never
with `model.init` (slow un-jitted on CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from textualdegremoval_tpu.convert import convert_state_dict


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
    holder = torch.nn.Module()
    setattr(holder, name, module)
    return convert_state_dict(holder.state_dict())[name]


def assert_close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)
