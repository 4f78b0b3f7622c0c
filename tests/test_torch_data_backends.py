"""PyTorch port vs JAX package: the keyed-archive data backends.

The LMDB reader on archives written from the format spec
(tests/lmdb_spec_writer.py), the packed TFRecord writer and reader, the
crc32c, `FileClient`, `paired_paths_from_lmdb`, `duf_downsample`, and the
WithRef datasets with io_backend lmdb and tfrecord: bytes bit for bit
against JAX's readers; items bit for bit against the port's disk backend,
and within one float32 ulp of 1.0 of JAX's datasets (JAX decodes with
cv2, which divides by 255 where the port multiplies by 1/255,
tests/test_torch_datasets.py).  The native binding against JAX's where
both libraries are already built (JAX's builds with make inside native/,
which this file never triggers).  The training CLI on each archive, and
the device prefetcher's order.
"""

import json
import os

import numpy as np
import pytest
import torch

import textualdegremoval_tpu.data.datasets as jds
import textualdegremoval_tpu.data.native as jnative
from textualdegremoval_tpu.data import lmdb_reader as jlmdb
from textualdegremoval_tpu.data import packed as jpacked
from textualdegremoval_tpu.data.pairing import (
    paired_paths_from_lmdb as j_paired_paths_from_lmdb,
)
from textualdegremoval_tpu.data.transforms import (
    duf_downsample as j_duf_downsample,
)
from textualdegremoval_tpu.utils.file_client import FileClient as JFileClient

from textualdegremoval_tpu_torch.data import datasets as tds
from textualdegremoval_tpu_torch.data import lmdb_reader as plmdb
from textualdegremoval_tpu_torch.data import native as pnative
from textualdegremoval_tpu_torch.data import packed as ppacked
from textualdegremoval_tpu_torch.data.loader import (
    DevicePrefetcher, create_dataloader, create_dataset,
)
from textualdegremoval_tpu_torch.data.pairing import paired_paths_from_lmdb
from textualdegremoval_tpu_torch.data.png import write_png
from textualdegremoval_tpu_torch.data.transforms import duf_downsample
from textualdegremoval_tpu_torch.utils.file_client import FileClient

from lmdb_spec_writer import write_lmdb

ULP1 = float(np.spacing(np.float32(1.0)))
KINDS = ("lq", "hq", "ref")


@pytest.fixture(autouse=True)
def _jax_reads_with_cv2(monkeypatch):
    """The JAX side decodes with cv2 and crcs in Python: its native build
    (make -C native) is never triggered here."""
    monkeypatch.setattr(jnative, "decode_available", lambda: False)
    monkeypatch.setattr(jnative, "crc32c_available", lambda: False)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Three folders of 8-bit PNGs (one item smaller than gt_size, so the
    reflect padding runs), their LMDB archives (spec writer, meta_info)
    and their packed archives (the port's packer)."""
    root = tmp_path_factory.mktemp("backends")
    rng = np.random.default_rng(0)
    for i in range(4):
        hw = (30, 52) if i == 1 else (40, 44)
        for kind in KINDS:
            (root / kind).mkdir(exist_ok=True)
            write_png(str(root / kind / f"img_{i:02d}.png"),
                      (rng.random((*hw, 3)) * 255).astype(np.uint8))
    for kind in KINDS:
        files = sorted((root / kind).iterdir())
        write_lmdb(str(root / f"{kind}.lmdb"),
                   {f.stem: f.read_bytes() for f in files})
        assert ppacked.pack_image_folder(str(root / kind),
                                         str(root / f"{kind}_packed")) == 4
    return root


def _roots(root, io):
    suffix = {"disk": "", "lmdb": ".lmdb", "tfrecord": "_packed"}[io]
    return {f"{k}root": str(root / f"{kind}{suffix}")
            for k, kind in zip(("lq", "hq", "ref"), KINDS)}


def test_lmdb_reader_matches_jax(tmp_path):
    """Values inline and on overflow pages, over several leaves under a
    branch page: keys, items and lookups equal JAX's parser's."""
    rng = np.random.default_rng(1)
    kv = {f"k{i:03d}": rng.integers(0, 256, int(n), np.uint8).tobytes()
          for i, n in enumerate(rng.integers(1, 9000, 60))}
    write_lmdb(str(tmp_path / "db.lmdb"), kv)
    mine = plmdb.PurePythonLmdb(str(tmp_path / "db.lmdb"))
    theirs = jlmdb.PurePythonLmdb(str(tmp_path / "db.lmdb"))
    assert mine.depth == theirs.depth == 2 and len(mine) == len(kv)
    assert list(mine.items()) == list(theirs.items())
    for k, v in kv.items():
        assert mine.get(k) == theirs.get(k) == v
    with pytest.raises(KeyError):
        mine.get("absent")
    keyed, jkeyed = (m.LmdbKeyedReader(str(tmp_path / "db.lmdb"))
                     for m in (plmdb, jlmdb))
    assert keyed.keys() == jkeyed.keys() == sorted(kv)
    assert keyed.filename("k000") == jkeyed.filename("k000") == "k000.png"


def test_packed_writer_reader_and_crc_match_jax(archives, tmp_path):
    """The port's packer writes JAX's bytes (archive and index); each
    reader reads the other's archive; crc32c (Python and native) equals
    JAX's Python loop; the index-free scan and verify read the same."""
    src = str(archives / "lq")
    jpacked.pack_image_folder(src, str(tmp_path / "j"))
    for ext in (".tfrecord", ".index.json"):
        assert (archives / f"lq_packed{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    mine = ppacked.PackedImageReader(str(tmp_path / "j"), verify=True)
    theirs = jpacked.PackedImageReader(str(archives / "lq_packed"))
    assert mine.keys() == theirs.keys() == [f"img_{i:02d}.png"
                                            for i in range(4)]
    for k in mine.keys():
        assert mine.get(k) == theirs.get(k) == (archives / "lq" / k
                                                ).read_bytes()
    data = (archives / "lq" / "img_00.png").read_bytes()
    want = jpacked._crc32c_py(data)
    assert ppacked.crc32c_py(data) == want
    if pnative.dataio_available():
        assert pnative.crc32c(data) == want
    assert ppacked.masked_crc32c(data) == jpacked.masked_crc32c(data)
    assert [p for _, p in ppacked.iterate_records(
        str(tmp_path / "j.tfrecord"), verify=True)] == \
        [p for _, p in jpacked.iterate_records(str(tmp_path / "j.tfrecord"))]
    os.remove(tmp_path / "j.index.json")  # lost: the scan rebuilds it
    assert ppacked.PackedImageReader(str(tmp_path / "j")).keys() == \
        mine.keys()


def test_packed_verify_catches_a_corrupt_payload(archives, tmp_path):
    blob = bytearray((archives / "lq_packed.tfrecord").read_bytes())
    blob[40] ^= 0xFF
    (tmp_path / "bad.tfrecord").write_bytes(bytes(blob))
    (tmp_path / "bad.index.json").write_text(
        (archives / "lq_packed.index.json").read_text())
    with pytest.raises(IOError, match="payload crc mismatch"):
        ppacked.PackedImageReader(str(tmp_path / "bad"),
                                  verify=True).get("img_00.png")


@pytest.mark.parametrize("backend", ["disk", "lmdb", "tfrecord"])
def test_file_client_matches_jax(archives, backend):
    kw = {"disk": {}, "lmdb": {"db_path": str(archives / "lq.lmdb")},
          "tfrecord": {"db_path": str(archives / "lq_packed")}}[backend]
    key = {"disk": str(archives / "lq" / "img_02.png"), "lmdb": "img_02",
           "tfrecord": "img_02.png"}[backend]
    assert FileClient(backend, **kw).get(key) == \
        JFileClient(backend, **kw).get(key) == \
        (archives / "lq" / "img_02.png").read_bytes()


def test_file_client_refusals():
    with pytest.raises(ValueError, match="not supported"):
        FileClient("nothing")
    with pytest.raises(ImportError, match="mc client"):
        FileClient("memcached", server_list_cfg="a", client_cfg="b")


def test_imdecode_equals_imread_on_every_decoder(archives, monkeypatch):
    """An archive's bytes decode to the file's item bit for bit: through
    the native decoder (where it builds), cv2, and data/png.py."""
    path = str(archives / "ref" / "img_01.png")
    data = open(path, "rb").read()
    want = tds.imread_f32(path)
    assert np.array_equal(tds.imdecode_f32(data), want)
    monkeypatch.setattr(pnative, "decode_available", lambda: False)
    assert np.array_equal(tds.imread_f32(path), want)
    monkeypatch.setattr(tds, "_cv2", lambda: None)
    assert np.array_equal(tds.imdecode_f32(data), want)
    assert np.array_equal(tds.imread_f32(path), want)


@pytest.mark.parametrize("io", ["lmdb", "tfrecord"])
@pytest.mark.parametrize("dataset", ["Dataset_PairedImageWithRef",
                                     "Dataset_PairedDehazeWithRef"])
def test_archive_datasets_match_disk_and_jax(archives, io, dataset):
    """Items from each archive equal the disk backend's bit for bit under
    the same seed, and JAX's archive dataset's within one ulp of 1.0."""
    opt = {"type": dataset, "phase": "train", "gt_size": 32,
           "geometric_augs": True, "seed": 5}
    jcls = {"Dataset_PairedImageWithRef": jds.PairedImageWithRefDataset,
            "Dataset_PairedDehazeWithRef": jds.PairedDehazeWithRefDataset}
    items = []
    for make, io_type in ((create_dataset, "disk"), (create_dataset, io),
                          (jcls[dataset], io)):
        ds = make({**opt, **_roots(archives, io_type),
                   "io_backend": {"type": io_type}})
        assert len(ds) == 4
        items.append([ds[i] for i in range(len(ds))])
    for disk, arch, jax_item in zip(*items):
        for k in ("lq", "gt", "ref"):
            assert np.array_equal(arch[k], disk[k]), k
            np.testing.assert_allclose(arch[k], jax_item[k], rtol=0,
                                       atol=ULP1)
        assert arch["lq_path"] == jax_item["lq_path"]


@pytest.mark.parametrize("io", ["lmdb", "tfrecord"])
def test_archives_that_disagree_on_keys_raise_as_jax(archives, tmp_path, io):
    if io == "lmdb":
        files = sorted((archives / "ref").iterdir())[:3]
        write_lmdb(str(tmp_path / "ref.lmdb"),
                   {f.stem: f.read_bytes() for f in files})
        ref = str(tmp_path / "ref.lmdb")
    else:
        (tmp_path / "few").mkdir()
        for f in sorted((archives / "ref").iterdir())[:3]:
            (tmp_path / "few" / f.name).write_bytes(f.read_bytes())
        ppacked.pack_image_folder(str(tmp_path / "few"), str(tmp_path / "r"))
        ref = str(tmp_path / "r")
    opt = {**_roots(archives, io), "refroot": ref,
           "io_backend": {"type": io}, "phase": "train"}
    errors = []
    for cls in (tds.PairedImageWithRefDataset, jds.PairedImageWithRefDataset):
        with pytest.raises(ValueError, match="disagree on keys") as e:
            cls(opt)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_paired_paths_from_lmdb_matches_jax(archives, tmp_path):
    folders = (str(archives / "lq.lmdb"), str(archives / "hq.lmdb"))
    got = paired_paths_from_lmdb(folders, ("lq", "gt"))
    assert got == j_paired_paths_from_lmdb(folders, ("lq", "gt"))
    assert [r["lq_path"] for r in got] == [f"img_{i:02d}" for i in range(4)]
    # without meta_info.txt the keys come from a scan of the B-tree
    write_lmdb(str(tmp_path / "scan.lmdb"), {"a": b"1", "b": b"2"},
               meta_info=False)
    write_lmdb(str(tmp_path / "scan2.lmdb"), {"a": b"3", "b": b"4"},
               meta_info=False)
    pair = (str(tmp_path / "scan.lmdb"), str(tmp_path / "scan2.lmdb"))
    assert paired_paths_from_lmdb(pair, ("lq", "gt")) == \
        j_paired_paths_from_lmdb(pair, ("lq", "gt"))
    for bad in ((str(archives / "lq"), folders[1]),
                (folders[0], str(tmp_path / "scan.lmdb"))):
        with pytest.raises(ValueError):
            paired_paths_from_lmdb(bad, ("lq", "gt"))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample_matches_jax(scale):
    x = np.random.default_rng(scale).random((2, 3, 36, 48, 3))
    got = duf_downsample(x, scale=scale)
    assert got.shape == (2, 3, 36 // scale, 48 // scale, 3)
    np.testing.assert_array_equal(got, j_duf_downsample(x, scale=scale))


def test_native_binding_matches_jax(archives):
    """decode_rgb and crc32c against JAX's binding, where both libraries
    are already built (the port's under build/native/, JAX's in native/)."""
    if not pnative.decode_available() or not os.path.exists(jnative._DEC_SO) \
            or not os.path.exists(jnative._SO):
        pytest.skip("a native library is not built")
    path = str(archives / "hq" / "img_03.png")
    assert np.array_equal(pnative.decode_rgb(path), jnative.decode_rgb(path))
    data = open(path, "rb").read()
    assert pnative.crc32c(data) == jnative.crc32c(data)


def test_training_cli_on_each_archive(archives, monkeypatch):
    """One iteration of cli/train_restoration.py over each archive (the
    training and the val set from the archives), on the CPU."""
    from textualdegremoval_tpu_torch.cli.train_restoration import main

    monkeypatch.chdir(archives)
    net = {"type": "NAFNetRefFusion", "width": 8, "enc_blk_nums": [1, 1],
           "dec_blk_nums": [1, 1], "nf": 8, "ext_n_blocks": [1, 1],
           "reffusion_n_blocks": [1, 1], "lr_block_size": 4}
    for io in ("lmdb", "tfrecord"):
        ds = {"type": "Dataset_PairedImageWithRef", **_roots(archives, io),
              "io_backend": {"type": io}}
        opt = {"name": f"archive_{io}", "manual_seed": 1,
               "datasets": {
                   # batch 1: the fixture's references differ in size
                   "train": {**ds, "num_worker_per_gpu": 0, "gt_size": 32,
                             "batch_size_per_gpu": 1},
                   "val": dict(ds)},
               "network_g": net, "path": {},
               "train": {"total_iter": 1, "param_fix_iterations": 0,
                         "scheduler": {"type": "MultiStepRestartLR",
                                       "milestones": [10]},
                         "optim_g": {"type": "AdamW", "lr": 1e-3},
                         "pixel_opt": {"type": "L1Loss"}},
               "val": {"val_freq": 1, "max_minibatch": 1, "window_size": 16},
               "logger": {"print_freq": 1}}
        cfg = archives / f"{io}.json"
        cfg.write_text(json.dumps(opt))
        assert main(["--opt", str(cfg), "--device", "cpu"]).step == 1
        log = (archives / "experiments" / f"archive_{io}" / "train.log")
        assert "val @ 1: psnr" in log.read_text()


def test_prefetcher_keeps_order_and_count():
    """Every batch, in order, tensors moved and metadata passed through;
    on the CPU device (the CUDA stream path runs in chip_smoke.py)."""
    batches = [{"lq": torch.full((2, 3), float(i)), "name": [f"b{i}"]}
               for i in range(5)]
    got = list(DevicePrefetcher(batches, "cpu"))
    assert [b["name"] for b in got] == [[f"b{i}"] for i in range(5)]
    assert all(torch.equal(g["lq"], b["lq"]) for g, b in zip(got, batches))
    assert list(DevicePrefetcher([], "cpu")) == []
    loader = create_dataloader(
        _Numbers(), {"batch_size_per_gpu": 2, "num_worker_per_gpu": 0},
        device="cpu")
    loader.sampler.set_epoch(0)
    want = [b["i"].tolist() for b in loader]
    assert [b["i"].tolist() for b in DevicePrefetcher(loader, "cpu")] == want


class _Numbers:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"i": np.full((1,), i, np.float32)}
