"""PyTorch port vs JAX package: pipeline A's training data and CLIs, on the
CPU.

* The guidance datasets (`data/guidance.py`: UnpairedLQHQDataset,
  PairedLQHQDataset in its denoise and paired modes,
  ReferenceGenerationDataset) item for item against the JAX classes with
  the same seed, over images smaller and larger than the crop.  The port
  resizes with `resize_bilinear` where JAX calls cv2.resize (up to 3.8e-5
  apart on [0, 1] values): the SD view to 2e-4 (x 2 - 1), the CLIP view to
  1e-3 (two resizes over the smallest CLIP std, 0.26); a crop that needs
  no resize is exact.
* `train_i2t` and then `train_tr` for two micro-steps on the tiny towers
  (--device cpu --tiny_debug_towers, no loader workers: no fork in a
  process that has loaded JAX), each writing its trained part in the
  reference format (the I2T run also its --validation_samples grid); the
  I2T artifact and the TR clean mapper copied into
  a towers directory load through `load_reference_towers` into the towers
  that the TR run trained, and `generate_one` consumes them.
"""

import shutil

import cv2
import numpy as np
import pytest
import torch

from textualdegremoval_tpu.data import guidance as jguidance

from textualdegremoval_tpu_torch.cli import generate_reference as gen_cli
from textualdegremoval_tpu_torch.cli import train_i2t, train_tr
from textualdegremoval_tpu_torch.convert import (
    load_reference_towers, mapper_reference_state_dict,
)
from textualdegremoval_tpu_torch.data import guidance
from textualdegremoval_tpu_torch.diffusion import pipeline

SD_ATOL, CLIP_ATOL = 2e-4, 1e-3


def _write_images(root, shapes, seed):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        low = rng.random((h // 4 + 1, w // 4 + 1, 3))
        img = np.kron(low, np.ones((4, 4, 1)))[:h, :w]
        cv2.imwrite(str(root / f"{i:02d}.png"),
                    (img * 255).round().astype(np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("guidance_data")
    shapes = [(40, 52), (24, 30), (64, 36), (33, 33)]
    return {"hq": _write_images(base / "hq", shapes, 0),
            "lq": _write_images(base / "lq", shapes, 1)}


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            atol = CLIP_ATOL if key == "pixel_values_clip" else SD_ATOL
            np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                       err_msg=key)
        else:
            assert g == w, key


def test_unpaired_dataset_matches_jax(image_dirs):
    kw = dict(size=32, placeholder_index=5, seed=3, clip_size=28)
    got = guidance.UnpairedLQHQDataset(image_dirs["hq"], **kw)
    want = jguidance.UnpairedLQHQDataset(image_dirs["hq"], **kw)
    assert len(got) == len(want) == 4
    for idx in (0, 1, 2, 3, 0, 3):
        _assert_items_equal(got[idx], want[idx])
    # an image that covers the crop is cropped, not resized: exact
    big = guidance.UnpairedLQHQDataset(image_dirs["hq"], **kw)[0]
    ref = jguidance.UnpairedLQHQDataset(image_dirs["hq"], **kw)[0]
    assert np.array_equal(big["pixel_values"], ref["pixel_values"])


@pytest.mark.parametrize("mode", ["denoise", "paired"])
def test_paired_dataset_matches_jax(image_dirs, mode):
    roots = ({"denoise": (None, image_dirs["hq"])} if mode == "denoise"
             else {"paired": (image_dirs["lq"], image_dirs["hq"]),
                   "denoise": (None, image_dirs["hq"])})
    kw = dict(size=32, placeholder_index=4, sigma_range=(5, 50), seed=7,
              clip_size=28)
    got = guidance.PairedLQHQDataset(roots, **kw)
    want = jguidance.PairedLQHQDataset(roots, **kw)
    assert len(got) == len(want)
    for idx in range(6):
        _assert_items_equal(got[idx % 4], want[idx % 4])


def test_reference_generation_dataset_matches_jax(image_dirs):
    got = guidance.ReferenceGenerationDataset(image_dirs["hq"], size=48,
                                              placeholder_index=5)
    want = jguidance.ReferenceGenerationDataset(image_dirs["hq"], size=48,
                                                placeholder_index=5)
    for idx in range(4):
        _assert_items_equal(got[idx], want[idx])


def _cli_argv(data, out, *extra):
    return ["--train_data_dir", data, "--output_dir", str(out),
            "--device", "cpu", "--tiny_debug_towers", "--num_words", "4",
            "--resolution", "32", "--train_batch_size", "2",
            "--gradient_accumulation_steps", "2", "--max_train_steps", "2",
            "--save_steps", "2", "--num_workers", "0",
            "--learning_rate", "1e-3", *extra]


def _named(mods):
    return {f"{tw}.{n}": p.detach().clone()
            for tw, m in mods.towers().items()
            for n, p in m.named_parameters()}


def test_train_clis_save_what_generation_loads(image_dirs, tmp_path):
    i2t = train_i2t.main(_cli_argv(image_dirs["hq"], tmp_path / "i2t",
                                   "--random_init", "--validation_samples",
                                   "--validation_steps", "2"))
    artifact = tmp_path / "i2t" / "i2t_params_2" / "mapper.pt"
    assert artifact.exists()
    grid = cv2.imread(str(tmp_path / "i2t" / "i2t_sample_000002.jpg"))
    assert grid.shape == (32, 64, 3)  # input | sample at the crop size

    # a towers directory: the I2T run's towers, its artifact, and the
    # seeded clean mapper
    towers = tmp_path / "towers"
    towers.mkdir()
    for name in ("text_encoder", "image_encoder", "vae", "unet"):
        sd = getattr(i2t, name).state_dict()
        torch.save({k: v for k, v in sd.items() if "_global" not in k},
                   towers / f"{name}.pt")
    shutil.copy(artifact, towers / "mapper.pt")
    torch.save(mapper_reference_state_dict(i2t.clean_mapper),
               towers / "clean_mapper.pt")
    loaded = pipeline.GuidanceModules.small_test_config(num_words=4)
    load_reference_towers(loaded, str(towers))
    before = _named(loaded)
    assert all(torch.equal(v, _named(i2t)[k]) for k, v in before.items())

    tr = train_tr.main(_cli_argv(image_dirs["lq"], tmp_path / "tr",
                                 "--pretrained_params", str(towers),
                                 "--train_data_dir_hq", image_dirs["hq"]))
    after = _named(tr)
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed == {k for k in before if k.startswith("clean_mapper.")}
    shutil.copy(tmp_path / "tr" / "tr_params_2" / "clean_mapper.pt",
                towers / "clean_mapper.pt")

    final = pipeline.GuidanceModules.small_test_config(num_words=4)
    load_reference_towers(final, str(towers))
    assert all(torch.equal(v, after[k]) for k, v in _named(final).items())
    ids, uids, inj = train_i2t.prompt_ids(
        train_i2t.parse_args("i2t", _cli_argv("x", "y", "--random_init")),
        final)
    img = np.random.default_rng(3).random((40, 50, 3), dtype=np.float32)
    out = gen_cli.generate_one(
        final, img, torch.from_numpy(ids), torch.from_numpy(uids),
        torch.tensor([inj], dtype=torch.int32),
        torch.Generator().manual_seed(0), size=64, steps=2)
    assert out.dtype == np.uint8 and out.shape == (16, 16, 3)


def test_train_cli_refuses_to_run_without_weights(tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_i2t.main(["--train_data_dir", "x", "--output_dir",
                        str(tmp_path)])
    assert "--random_init" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_i2t.main(["--help"])
    assert "data-parallel ranks under torchrun" in capsys.readouterr().out
