"""Gating primitives shared by the backbones (NHWC).

Counterpart of textualdegremoval_tpu/ops/ffn.py.
"""

import torch


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    """NAFNet's SimpleGate: split the channels in half and multiply."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return x1 * x2
