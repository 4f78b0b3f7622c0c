"""Numeric ops of the port, on NHWC tensors like the JAX package's."""

from textualdegremoval_tpu_torch.ops.norm import (
    bias_free_layer_norm,
    layer_norm_2d,
    with_bias_layer_norm,
)
from textualdegremoval_tpu_torch.ops.ffn import simple_gate
from textualdegremoval_tpu_torch.ops.resize import (
    bilinear_resize_torch,
    pixel_shuffle,
    pixel_unshuffle,
    pad_to_multiple,
)
from textualdegremoval_tpu_torch.ops.attention import (
    mdta_attention_nhwc,
    tksa_attention,
)
from textualdegremoval_tpu_torch.ops.dwconv import dwconv
from textualdegremoval_tpu_torch.ops.masa import (
    masa_coarse_search,
    masa_fine_search,
    masa_gather_windows,
    masa_transfer,
    masa_window_corners,
    masa_match_and_warp,
    unfold_nhwc,
)

__all__ = [
    "bias_free_layer_norm",
    "layer_norm_2d",
    "with_bias_layer_norm",
    "simple_gate",
    "bilinear_resize_torch",
    "pixel_shuffle",
    "pixel_unshuffle",
    "pad_to_multiple",
    "mdta_attention_nhwc",
    "tksa_attention",
    "dwconv",
    "masa_coarse_search",
    "masa_fine_search",
    "masa_gather_windows",
    "masa_transfer",
    "masa_window_corners",
    "masa_match_and_warp",
    "unfold_nhwc",
]
