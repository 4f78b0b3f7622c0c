"""The port's leg of the real-pretrained-weight gate (tests/
test_real_weight_parity.py; ROADMAP A8 item 4): the same two asset
commands through the port's evaluation CLI on the CPU (`--device cpu`),
the same `$TDR_ASSETS_DIR` layout, and the same gate against
expected.json: PSNR within 0.05 dB and SSIM within 0.002 of the
reference's.

Without `net_g.pth` a test skips, as JAX's does; like JAX's they are full
evaluations and marked slow.  The command path itself is held on seeded
checkpoints in the reference's `{'params': sd}` layout against JAX's CLI
by `test_evaluate_cli_matches_jax_cli` in tests/test_torch_restormer.py
and tests/test_torch_nafnet.py, so nothing of it is repeated here.
"""

import json
import os

import pytest

# the assets' root: $TDR_ASSETS_DIR, else assets/ at the repository's root
ASSETS = os.environ.get("TDR_ASSETS_DIR", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets"))


def _asset_dir(name):
    d = os.path.join(ASSETS, name)
    if not os.path.exists(os.path.join(d, "net_g.pth")):
        pytest.skip(f"no pretrained assets at {d} (net_g.pth)")
    return d


def _run_eval(task, droot, sigma=None, lq=False):
    from textualdegremoval_tpu_torch.cli.evaluate import main

    argv = ["--task", task, "--hqroot", os.path.join(droot, "hq"),
            "--refroot", os.path.join(droot, "ref"),
            "--checkpoint_path", os.path.join(droot, "net_g.pth"),
            "--device", "cpu"]
    if sigma is not None:
        argv += ["--sigma", str(sigma)]
    if lq:
        argv += ["--lqroot", os.path.join(droot, "lq")]
    return main(argv)


def _check_expected(droot, psnr, ssim):
    exp_path = os.path.join(droot, "expected.json")
    if not os.path.exists(exp_path):
        print(f"no expected.json in {droot}; measured psnr={psnr:.4f} "
              f"ssim={ssim:.4f} (recorded, not gated)")
        return
    with open(exp_path) as f:
        exp = json.load(f)
    assert abs(psnr - float(exp["psnr"])) <= 0.05, (
        f"PSNR {psnr:.4f} vs reference {exp['psnr']:.4f}: gate 0.05 dB")
    if "ssim" in exp:
        assert abs(ssim - float(exp["ssim"])) <= 0.002


@pytest.mark.slow
def test_config1_restormer_color_denoise15_cbsd68():
    droot = _asset_dir("restormer_color_denoise15")
    psnr, ssim = _run_eval("restormer_color_denoise", droot, sigma=15)
    _check_expected(droot, psnr, ssim)


@pytest.mark.slow
def test_config2_nafnet_gopro_deblur():
    droot = _asset_dir("nafnet_gopro")
    psnr, ssim = _run_eval("nafnet_deblur", droot, lq=True)
    _check_expected(droot, psnr, ssim)
