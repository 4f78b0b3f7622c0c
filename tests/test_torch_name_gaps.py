"""Public functions of the JAX package that the port had no counterpart
for, each against its JAX twin on seeded inputs: the native data-path
bindings (`data/native.py`: u8_to_f32, augment_f32, add_gaussian_noise,
batch_prepare, decode_batch_rgb; the port builds native/*.cc itself into
build/native/, JAX's loader runs make in native/), `tri_paths_from_lmdb`,
`img_rotate`, `dict2str`, `register_network` and the lmdb -> packed
TFRecord converter (tools/lmdb_to_tfrecord.py), whose archive the port's
reader reads back bit-equal to the lmdb's values."""

from pathlib import Path

import numpy as np
import pytest
import torch

from textualdegremoval_tpu.data import native as jnative
from textualdegremoval_tpu.data.pairing import (
    tri_paths_from_lmdb as j_tri_paths_from_lmdb)
from textualdegremoval_tpu.data.transforms import img_rotate as j_img_rotate
from textualdegremoval_tpu.utils.options import dict2str as j_dict2str

from textualdegremoval_tpu_torch.data import native as pnative
from textualdegremoval_tpu_torch.data.packed import open_packed
from textualdegremoval_tpu_torch.data.pairing import tri_paths_from_lmdb
from textualdegremoval_tpu_torch.data.png import write_png
from textualdegremoval_tpu_torch.data.transforms import img_rotate
from textualdegremoval_tpu_torch.utils.options import dict2str

from lmdb_spec_writer import write_lmdb


@pytest.fixture(scope="module")
def both_native():
    if not (pnative.dataio_available() and jnative.native_available()):
        pytest.skip("g++ or the native data library is unavailable")


def test_u8_to_f32_matches_jax(both_native):
    src = np.random.default_rng(0).integers(0, 256, (7, 9, 3), np.uint8)
    got = pnative.u8_to_f32(src)
    assert got.dtype == np.float32 and got.shape == src.shape
    assert np.array_equal(got, jnative.u8_to_f32(src))
    np.testing.assert_allclose(got, src / 255.0, rtol=1e-6)


@pytest.mark.parametrize("mode", range(8))
def test_augment_f32_matches_jax(both_native, mode):
    src = np.random.default_rng(mode).random((5, 7, 3), np.float32)
    got = pnative.augment_f32(src, mode)
    assert np.array_equal(got, jnative.augment_f32(src, mode))


def test_add_gaussian_noise_matches_jax(both_native):
    src = np.random.default_rng(1).random((16, 12, 3), np.float32)
    got = pnative.add_gaussian_noise(src, 15.0, 1234)
    want = jnative.add_gaussian_noise(src, 15.0, 1234)
    # the same generator and transform; the two builds' flags may contract
    # the transform's float math differently
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert 0.04 < float((got - src).std()) < 0.08  # sigma / 255
    assert np.array_equal(got, pnative.add_gaussian_noise(src, 15.0, 1234))


def test_batch_prepare_matches_jax(both_native):
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (20 + i, 24, 3), np.uint8)
              for i in range(3)]
    crops, modes = [(1, 2), (0, 5), (3, 0)], [0, 3, 6]
    got = pnative.batch_prepare(images, crops, 16, modes, n_threads=2)
    assert got.shape == (3, 16, 16, 3)
    assert np.array_equal(got, jnative.batch_prepare(images, crops, 16,
                                                     modes, n_threads=2))
    want0 = pnative.augment_f32(pnative.u8_to_f32(
        images[1][0:16, 5:21]), 3)
    assert np.array_equal(got[1], want0)


def test_decode_batch_rgb_matches_jax(tmp_path):
    if not (pnative.decode_available() and jnative.decode_available()):
        pytest.skip("the native decoder (libpng, libjpeg) is unavailable")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"{i}.png")
        write_png(path, rng.integers(0, 256, (9 + i, 11, 3), np.uint8))
        paths.append(path)
    got = pnative.decode_batch_rgb(paths, n_threads=2)
    want = jnative.decode_batch_rgb(paths, n_threads=2)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert all(np.array_equal(g, pnative.decode_rgb(p))
               for g, p in zip(got, paths))
    with pytest.raises(IOError):
        pnative.decode_batch_rgb([str(tmp_path / "absent.png")])


def test_tri_paths_from_lmdb_matches_jax(tmp_path):
    folders = []
    for kind in ("lq", "hq", "ref"):
        folders.append(str(tmp_path / f"{kind}.lmdb"))
        write_lmdb(folders[-1], {f"img_{i}": bytes([i]) for i in range(3)})
    keys = ("lq", "gt", "ref")
    got = tri_paths_from_lmdb(folders, keys)
    assert got == j_tri_paths_from_lmdb(folders, keys)
    assert got[1] == {"lq_path": "img_1", "gt_path": "img_1",
                      "ref_path": "img_1"}
    write_lmdb(str(tmp_path / "odd.lmdb"), {"img_0": b"0", "x": b"1"})
    with pytest.raises(ValueError, match="differ"):
        tri_paths_from_lmdb(folders[:2] + [str(tmp_path / "odd.lmdb")], keys)


@pytest.mark.parametrize("angle,center,scale", [
    (30.0, None, 1.0), (-90.0, (3, 4), 1.0), (12.5, None, 0.8)])
def test_img_rotate_matches_jax(angle, center, scale):
    img = np.random.default_rng(4).random((13, 17, 3), np.float32)
    got = img_rotate(img, angle, center, scale)
    assert np.array_equal(got, j_img_rotate(img, angle, center, scale))
    assert got.shape == img.shape


def test_dict2str_matches_jax():
    opt = {"name": "x", "train": {"lr": 2e-4, "sched": {"periods": [1, 2]}},
           "num_gpu": 4}
    assert dict2str(opt) == j_dict2str(opt)
    assert dict2str(opt, indent=2) == j_dict2str(opt, indent=2)
    assert dict2str(opt).splitlines()[2] == "    lr: 0.0002"


def test_register_network_matches_jax():
    from textualdegremoval_tpu import models as jmodels
    from textualdegremoval_tpu_torch import models as pmodels

    class TinyNet(torch.nn.Module):
        def __init__(self, width: int = 2, dtype=torch.float32):
            super().__init__()
            self.width = width

    try:
        assert pmodels.register_network(TinyNet) is TinyNet
        assert pmodels.register_network(TinyNet, "Alias") is TinyNet
        assert {"TinyNet", "Alias"} <= set(pmodels.network_names())
        net = pmodels.define_network({"type": "Alias", "width": 5})
        assert isinstance(net, TinyNet) and net.width == 5
        # JAX's registers the same way: by class name, or the name given
        assert jmodels.register_network(TinyNet, "Alias") is TinyNet
        assert jmodels._REGISTRY["Alias"] is TinyNet
    finally:
        for reg in (pmodels._REGISTRY, jmodels._REGISTRY):
            reg.pop("TinyNet", None)
            reg.pop("Alias", None)


def test_lmdb_to_tfrecord_matches_jax_tool(tmp_path):
    import importlib.util

    from textualdegremoval_tpu_torch.tools import lmdb_to_tfrecord

    rng = np.random.default_rng(5)
    kv = {f"img_{i:02d}": rng.integers(0, 256, int(n), np.uint8).tobytes()
          for i, n in enumerate(rng.integers(10, 5000, 6))}
    src = str(tmp_path / "src.lmdb")
    write_lmdb(src, kv)
    assert lmdb_to_tfrecord.main([src, str(tmp_path / "port")]) == 0
    reader = open_packed(str(tmp_path / "port"))
    assert reader.keys() == [f"{k}.png" for k in sorted(kv)]
    for k, v in kv.items():
        assert reader.get(f"{k}.png") == v
    spec = importlib.util.spec_from_file_location(
        "jax_lmdb_to_tfrecord",
        Path(__file__).resolve().parents[1] / "tools" / "lmdb_to_tfrecord.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.convert(src, str(tmp_path / "jax")) == len(kv)
    for ext in (".tfrecord", ".index.json"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()
    assert lmdb_to_tfrecord.main([src]) == 2
