"""The port's restoration datasets against the JAX package's, item for item.

Synthetic folders (8-bit PNGs, 16-bit PNGs for the dual-pixel set, a
meta_info file for dehaze) are written with cv2 from seeded numpy; each
side gets the same options and the same `np.random.seed` before its items,
0 workers.  The JAX side reads through cv2 (its native decoder is turned
off), which scales 8-bit values by /255 where the port multiplies by
1/255, so arrays that come from 8-bit files agree within one float32 ulp of
1.0 (two for luma, a weighted sum of such values rounded once more);
16-bit files agree exactly.  Also: the port's numpy PNG path (for
machines without cv2) against cv2, collate's refusal of mixed reference
sizes, and numpy's per-worker noise in spawned loader workers.
"""

import numpy as np
import pytest
import torch

import textualdegremoval_tpu.data.datasets as jds
import textualdegremoval_tpu.data.native as jnative
from textualdegremoval_tpu_torch.data import datasets as tds
from textualdegremoval_tpu_torch.data.loader import (
    _DATASETS, collate, create_dataloader, create_dataset,
)
from textualdegremoval_tpu_torch.data.png import read_png, write_png

ULP1 = float(np.spacing(np.float32(1.0)))  # one float32 ulp at 1.0


@pytest.fixture(autouse=True)
def _jax_reads_with_cv2(monkeypatch):
    """The JAX side decodes with cv2, never through the native build."""
    monkeypatch.setattr(jnative, "decode_available", lambda: False)


def _write(path, img):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), img[..., ::-1] if img.ndim == 3 else img)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)

    def u8(h, w):
        return (rng.random((h, w, 3)) * 255).astype(np.uint8)

    for i in range(3):
        name = f"img_{i:02d}.png"
        # gt smaller than gt_size on one item: the reflect padding runs
        h, w = (30, 52) if i == 1 else (40, 44)
        for sub in ("lq", "hq", "ref"):
            _write(root / "paired" / sub / name, u8(h, w))
        for task in ("denoise", "derain", "dehaze"):
            for sub in ("lq", "hq", "ref"):
                _write(root / task / sub / name, u8(40, 44))
        for sub in ("gt", "lqL", "lqR"):
            _write(root / "dp" / sub / name,
                   (rng.random((36, 40, 3)) * 65535).astype(np.uint16))
        _write(root / "dp" / "ref" / name, u8(36, 40))
        # dehaze by meta_info: hazy names map to another gt name
        _write(root / "haze" / "lq" / f"haze_{i}.png", u8(40, 44))
        _write(root / "haze" / "ref" / f"haze_{i}.png", u8(40, 44))
        _write(root / "haze" / "hq" / f"clear_{i}.png", u8(40, 44))
    (root / "haze" / "meta.txt").write_text(
        "".join(f"haze_{i}.png clear_{i}.png\n" for i in range(3)))
    return root


def _items(cls, opt, n, seed=123):
    ds = cls(dict(opt))
    np.random.seed(seed)
    return [ds[i] for i in range(n)]


def _assert_items(got, want, exact=(), atol=ULP1):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if not isinstance(w[k], np.ndarray):
                assert g[k] == w[k], k
                continue
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            if k in exact:
                assert np.array_equal(g[k], w[k]), k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                           err_msg=k)


def _compare(folders, name, opt, n=6, exact=(), atol=ULP1):
    _assert_items(_items(_DATASETS[name], opt, n),
                  _items(getattr(jds, _DATASETS[name].__name__), opt, n),
                  exact, atol)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("in_ch", [1, 3])
@pytest.mark.parametrize("sigma", [
    ("constant", 25), ("random", [0, 50]), ("choice", [15, 25, 50])])
def test_gaussian_denoising_matches_jax(folders, phase, in_ch, sigma):
    opt = {"phase": phase, "hqroot": str(folders / "denoise" / "hq"),
           "refroot": str(folders / "denoise" / "ref"), "gt_size": 32,
           "sigma_type": sigma[0], "sigma_range": sigma[1],
           "sigma_test": 25, "in_ch": in_ch, "seed": 5}
    _compare(folders, "Dataset_GaussianDenoisingWithRef", opt,
             atol=ULP1 * (2 if in_ch == 1 else 1))


@pytest.mark.parametrize("phase,augs", [("train", True), ("train", False),
                                        ("val", False)])
def test_dual_pixel_matches_jax(folders, phase, augs):
    opt = {"phase": phase, "hqroot": str(folders / "dp" / "gt"),
           "lqlroot": str(folders / "dp" / "lqL"),
           "lqrroot": str(folders / "dp" / "lqR"),
           "refroot": str(folders / "dp" / "ref"), "gt_size": 32,
           "geometric_augs": augs, "seed": 3}
    _compare(folders, "Dataset_PairedImageWithRef_DualPixel_16bit", opt,
             exact=("lq", "gt"))


@pytest.mark.parametrize("tasks", [("denoise", "derain", "dehaze"),
                                   ("derain",), ("denoise", "dehaze")])
def test_unified_matches_jax_for_every_task(folders, tasks):
    opt = {"phase": "train", "gt_size": 32, "seed": 11}
    for t in tasks:
        opt[t] = {"hqroot": str(folders / t / "hq"),
                  "refroot": str(folders / t / "ref")}
        if t != "denoise":
            opt[t]["lqroot"] = str(folders / t / "lq")
    got = _items(tds.PairedUnifiedWithRefDataset, opt, 24)
    _assert_items(got, _items(jds.PairedUnifiedWithRefDataset, opt, 24))
    want = {t for t in tds.PairedUnifiedWithRefDataset.TASKS
            if t.split("_")[0] in tasks}
    assert {g["task"] for g in got} == want


@pytest.mark.parametrize("phase", ["train", "val"])
def test_paired_image_matches_jax(folders, phase):
    opt = {"phase": phase, "lqroot": str(folders / "paired" / "lq"),
           "hqroot": str(folders / "paired" / "hq"), "gt_size": 32,
           "geometric_augs": True, "seed": 2}
    _compare(folders, "Dataset_PairedImage", opt, n=3)


@pytest.mark.parametrize("meta", [True, False])
def test_dehaze_matches_jax(folders, meta):
    sub = "haze" if meta else "dehaze"
    opt = {"phase": "train", "lqroot": str(folders / sub / "lq"),
           "hqroot": str(folders / sub / "hq"),
           "refroot": str(folders / sub / "ref"), "gt_size": 32,
           "geometric_augs": True, "seed": 4}
    if meta:
        opt["meta_info_file"] = str(folders / "haze" / "meta.txt")
    _compare(folders, "Dataset_PairedDehazeWithRef", opt, n=3)


def test_registry_names_every_jax_dataset():
    from textualdegremoval_tpu.data import _DATASETS as JAX_DATASETS

    assert {k: v.__name__ for k, v in _DATASETS.items()} == \
        {k: v.__name__ for k, v in JAX_DATASETS.items()}
    with pytest.raises(ValueError, match="unknown dataset type"):
        create_dataset({"type": "Dataset_Nothing"})
    # the keyed archives serve the WithRef and dehaze datasets, as in JAX;
    # the others read folders and refuse them
    with pytest.raises(NotImplementedError, match="reads image folders"):
        create_dataset({"type": "Dataset_GaussianDenoisingWithRef",
                        "io_backend": {"type": "lmdb"}})


def test_collate_refuses_mixed_reference_sizes():
    a = {"lq": np.zeros((4, 4, 3), np.float32),
         "ref": np.zeros((8, 8, 3), np.float32), "task": "derain"}
    b = {**a, "ref": np.zeros((8, 6, 3), np.float32), "task": "dehaze"}
    out = collate([a, a])
    assert out["ref"].shape == (2, 8, 8, 3) and out["task"] == ["derain"] * 2
    with pytest.raises(ValueError, match="'ref' arrays of shapes"):
        collate([a, b])


@pytest.mark.parametrize("dtype,ch", [(np.uint8, 1), (np.uint8, 3),
                                      (np.uint8, 4), (np.uint16, 3)])
def test_numpy_png_path_matches_cv2(tmp_path, monkeypatch, dtype, ch):
    """Where cv2 is missing, `imread_f32` decodes PNGs with numpy alone
    (data/png.py) and `rgb2gray` weighs in numpy: the same arrays as cv2's,
    the luma within an ulp."""
    import cv2

    rng = np.random.default_rng(ch)
    top = 256 if dtype == np.uint8 else 65536
    img = np.cumsum(rng.integers(0, top, (23, 31, ch)), 1).astype(dtype)
    img = img[..., 0] if ch == 1 else img
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img if ch == 1 else img[..., [2, 1, 0, 3][:ch]])
    assert np.array_equal(read_png(str(path)), img)
    write_png(str(tmp_path / "b.png"), img)
    assert np.array_equal(read_png(str(tmp_path / "b.png")), img)
    want = [tds.imread_f32(str(path), bit16) for bit16 in (False, True)]
    gray = tds.rgb2gray(want[0])
    monkeypatch.setattr(tds, "_cv2", lambda: None)
    for bit16, w in zip((False, True), want):
        assert np.array_equal(tds.imread_f32(str(path), bit16), w)
    np.testing.assert_allclose(tds.rgb2gray(want[0]), gray, rtol=0,
                               atol=ULP1)


def test_loader_workers_draw_their_own_noise(folders, tmp_path):
    """Spawned workers: torch seeds numpy's global generator in each, so two
    workers draw different training noise over four copies of one image
    (crop and augmentation held fixed: the whole image, no augs)."""
    import cv2

    img = (np.random.default_rng(1).random((16, 16, 3)) * 255).astype(
        np.uint8)
    for sub in ("hq", "ref"):
        (tmp_path / sub).mkdir()
        for i in range(4):
            cv2.imwrite(str(tmp_path / sub / f"img_{i}.png"), img)
    opt = {"type": "Dataset_GaussianDenoisingWithRef", "phase": "train",
           "hqroot": str(tmp_path / "hq"), "refroot": str(tmp_path / "ref"),
           "gt_size": 16, "geometric_augs": False, "sigma_range": 25,
           "batch_size_per_gpu": 1, "num_worker_per_gpu": 2}
    loader = create_dataloader(create_dataset(opt), opt)
    torch.manual_seed(0)
    batches = list(loader)
    assert len(batches) == 4
    assert len({b["gt"].numpy().tobytes() for b in batches}) == 1
    assert len({b["lq"].numpy().tobytes() for b in batches}) == 4
