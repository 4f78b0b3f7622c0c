"""The host shim's Hopper primitives (tests/cuda_host_shim.h running
textualdegremoval_tpu_torch/csrc/hopper.cuh on the CPU), against plain
torch: a warpgroup product (wgmma) fed by TMA tile loads in each form the
flash kernels and the weight-gradient products use, and one TMA box against
the 128-byte swizzle formula.
The bf16 flash kernels' host tests (test_torch_flash_attn*.py) rest on
these: the shim must read operands as the card does, or a host test would
pass a kernel that the card runs wrong."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_port_util import CSRC, TESTS


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """tests/hopper_shim_check.cpp compiled for the CPU against the shim."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found; the host build needs it")
    so = tmp_path_factory.mktemp("hopper_shim") / "libhopper_shim.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-pthread",
         "-fno-strict-aliasing", f"-I{TESTS}", f"-I{CSRC}", "-o", str(so),
         str(TESTS / "hopper_shim_check.cpp")],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hopper_product.argtypes = [p, p, p, i, i, i, i, i]
    lib.hopper_box.argtypes = [p, i, i, i, i, p]
    return lib


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).bfloat16()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int16)


# (A from shared memory or registers, B K-major or MN-major, D): K-major B
# is the products over D (S = q K^T, S^T = K q^T, dP: A 64 x D, B N x D
# with N = 128 keys), MN-major B the products over the walked rows
# (O += P V, dV, dK, dQ: A 64 x 64, B 64 x D)
@pytest.mark.parametrize("rs", [False, True], ids=["ss", "rs"])
@pytest.mark.parametrize("mn_major", [False, True], ids=["kmajor", "mnmajor"])
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_matches_matmul(shim, rs, mn_major, d):
    rng = np.random.default_rng(d + 2 * mn_major + 4 * rs)
    n, k = (d, 64) if mn_major else (128, d)
    a = _bf16(rng, 64, k)
    b = _bf16(rng, k, n) if mn_major else _bf16(rng, n, k)
    c = torch.empty(64, n)
    assert shim.hopper_product(_bits(a).data_ptr(), _bits(b).data_ptr(),
                               c.data_ptr(), n, k, int(mn_major),
                               int(rs), 0) == 0
    want = a.double() @ (b.double() if mn_major else b.double().T)
    # bf16 products are exact in f32; the sums differ in order only
    torch.testing.assert_close(c.double(), want, atol=1e-4, rtol=1e-5)


# A MN-major (the transpose bit of A: rows of K holding 64 M values), as
# the weight-gradient products read both operands (csrc/wgrad.cu: K is the
# pixel axis of both), alone and with B MN-major, at each wgmma width those
# products take
@pytest.mark.parametrize("b_mn_major", [False, True],
                         ids=["b_kmajor", "b_mnmajor"])
@pytest.mark.parametrize("n,k", [(64, 128), (128, 64), (256, 64)])
def test_wgmma_mn_major_a_matches_matmul(shim, b_mn_major, n, k):
    rng = np.random.default_rng(n + k + b_mn_major)
    at = _bf16(rng, k, 64)  # A^T: (K, 64)
    b = _bf16(rng, k, n) if b_mn_major else _bf16(rng, n, k)
    c = torch.empty(64, n)
    assert shim.hopper_product(_bits(at).data_ptr(), _bits(b).data_ptr(),
                               c.data_ptr(), n, k, int(b_mn_major), 0,
                               1) == 0
    want = at.double().T @ (b.double() if b_mn_major else b.double().T)
    # bf16 products are exact in f32; the sums differ in order only
    torch.testing.assert_close(c.double(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("d,row0,rows", [
    (64, 0, 64),     # one box, inside the tensor
    (64, 40, 64),    # rows past N = 70 arrive as zeros
    (128, 8, 128),   # two boxes a row; past N from row 62
])
def test_tma_box_is_the_128_byte_swizzle(shim, d, row0, rows):
    n = 70
    src = _bf16(np.random.default_rng(row0), n, d)
    out = torch.zeros(rows * d * 2, dtype=torch.uint8)
    assert shim.hopper_box(_bits(src).data_ptr(), n, d, row0, rows,
                           out.data_ptr()) == 0
    got = out.view(torch.int16)
    want = torch.zeros(rows * d, dtype=torch.int16)
    bits = _bits(src)
    for x in range(d // 64):
        for r in range(rows):
            for col in range(64):
                # byte x*rows*128 + r*128 + 16 ((col/8) ^ (r%8)) + 2 (col%8)
                at = (x * rows * 128 + r * 128
                      + 16 * ((col // 8) ^ (r % 8)) + 2 * (col % 8)) // 2
                if row0 + r < n:
                    want[at] = bits[row0 + r, 64 * x + col]
    assert torch.equal(got, want)


def test_tensor_map_refuses_a_misaligned_base(shim):
    """A base 8 bytes off a 16-byte boundary is refused, as the CUDA driver
    refuses it (flash_attention's validation refuses it first)."""
    src = torch.zeros(64 * 64 + 8, dtype=torch.int16)
    out = torch.zeros(64 * 64 * 2, dtype=torch.uint8)
    assert src.data_ptr() % 16 == 0
    assert shim.hopper_box(src.data_ptr() + 8, 64, 64, 0, 64,
                           out.data_ptr()) != 0
