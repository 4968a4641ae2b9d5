"""The port's curation toolkit (``data/curation.py``, ``cli/curate.py``)
held against the JAX package's on seeded inputs: hashes, patch grids,
exemplar indices and flipbooks equal; the proofread-batch round trip
writes the same trees of file names and JSON, with pixel-equal images
(the port's uncompressed TIFFs read back with ``cv2.imread``); the
patch-quality filter scores the JAX filter's variables within 1e-5 and
keeps the same indices; the ``curate`` command round trip gives what the
JAX command gives."""

import json
import os

import pytest

for _dep in ("jax", "flax", "cv2"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import cv2
import jax
import numpy as np
import torch

from empanada_tpu.cli.curate import main as jax_curate
from empanada_tpu.data import curation as jcur
from empanada_torch.cli.curate import main as curate
from empanada_torch.data import curation as cur
from empanada_torch.data.image_files import write_png
from empanada_torch.data.utils.transforms import resize_area
from empanada_torch.weights import flax_to_torch
from tests.test_torch_torch_weights import _randomize

SCORE_TOL = 1e-5


def _textured(rng, shape):
    """Smooth random texture (block noise, upsampled) plus fine noise."""
    h, w = shape
    coarse = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1))
    img = np.kron(coarse, np.ones((16, 16)))[:h, :w]
    return np.clip(img + rng.normal(0, 8, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(512, 512), (300, 256), (300, 264),
                                   (128, 128), (64, 72), (16, 18),
                                   (331, 517)])
def test_area_resize_and_dhash_equal_cv2_and_jax(shape):
    rng = np.random.default_rng(shape[0] * shape[1])
    img = _textured(rng, shape)
    want = cv2.resize(img.astype(np.float32), (9, 8),
                      interpolation=cv2.INTER_AREA)
    got = resize_area(img.astype(np.float32), (8, 9))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(cur.dhash(img), jcur.dhash(img))
    rgb = np.stack([img, img[::-1], img[:, ::-1]], axis=-1)
    np.testing.assert_array_equal(cur.dhash(rgb, 6), jcur.dhash(rgb, 6))


def test_resize_area_refuses_to_grow():
    with pytest.raises(ValueError, match="shrinks only"):
        resize_area(np.zeros((4, 4), np.float32), (8, 9))


@pytest.mark.parametrize("crop", [256, 200])
def test_patch_and_hash_and_dedup_equal_jax(crop):
    rng = np.random.default_rng(crop)
    base = _textured(rng, (256, 256))
    img = np.tile(base, (3, 5))[:600, :1100].copy()
    img[300:, 700:] = _textured(rng, (300, 400))
    msk = (img > 180).astype(np.uint8) * 3
    got = cur.patch_and_hash(img, msk, crop_size=crop)
    want = jcur.patch_and_hash(img, msk, crop_size=crop)
    assert got["locs"] == want["locs"]
    for key in ("patches", "patch_masks", "hashes"):
        assert len(got[key]) == len(want[key]) > 1
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for seed in (0, 3):
        for d in (4, 12, 30):
            keep = cur.deduplicate_hashes(got["hashes"], d, seed)
            assert keep == jcur.deduplicate_hashes(want["hashes"], d, seed)
    if crop == 256:  # the grid follows the texture's period: duplicates
        assert len(cur.deduplicate_hashes(got["hashes"], 12)) < \
            len(got["hashes"])


def test_flipbooks_equal_jax():
    vol = np.random.default_rng(1).integers(0, 255, (11, 50, 60), np.uint8)
    centers = [(5, 25, 30), (0, 0, 0), (10, 49, 59), (3, 10, 55)]
    np.testing.assert_array_equal(
        cur.flipbooks_from_locations(vol, centers, span=5, size=24),
        jcur.flipbooks_from_locations(vol, centers, span=5, size=24))
    with pytest.raises(ValueError, match="odd"):
        cur.flipbooks_from_locations(vol, centers, span=4)


def _tree(root):
    """{relative path: loaded content} of a directory: JSON parsed,
    images read with cv2 (unchanged depth), .npy loaded."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".json"):
                with open(path) as f:
                    out[rel] = json.load(f)
            elif name.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                out[rel] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return out


def _same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel, value in tb.items():
        if isinstance(value, np.ndarray):
            assert ta[rel] is not None, rel
            assert ta[rel].dtype == value.dtype, rel
            np.testing.assert_array_equal(ta[rel], value, err_msg=rel)
        else:
            assert ta[rel] == value, rel
    return ta


def _proof_inputs(rng):
    span, n_books, h, w = 3, 5, 32, 40
    image = rng.integers(1, 255, (span * n_books, h, w), np.uint8)
    mask = rng.integers(0, 5, (span * n_books, h, w), np.uint8)
    attrs = [{"image_name": f"dsA-LOC-2d-{i}.jpg", "start": i * span,
              "end": i * span + span - 1,
              "median_confidence": 3 + (i % 2)} for i in range(n_books)]
    attrs[1].update(height=20, width=30)
    image[3 * 3:3 * 4, :, 25:] = 0  # padding the content recovers
    attrs[-1]["image_name"] = "dsB-ROI-7.jpg"
    return image, mask, attrs


def test_proofread_round_trip_equals_jax(tmp_path):
    """split_proof_stack -> merge_annotation_batch -> group_annotation_dirs
    give the JAX package's trees, JSON and pixels."""
    image, mask, attrs = _proof_inputs(np.random.default_rng(4))
    roots = {}
    for name, mod in (("port", cur), ("jax", jcur)):
        root = tmp_path / name
        written = mod.split_proof_stack(image, mask, attrs,
                                        str(root / "batch"), ignore={2})
        assert written == ["dsA-LOC-2d-0", "dsA-LOC-2d-1", "dsA-LOC-2d-3",
                           "dsB-ROI-7"]
        touched = mod.merge_annotation_batch(str(root / "batch"),
                                             str(root / "train"))
        assert touched == ["dsA", "dsB"]
        roots[name] = root
    batch = _same_tree(roots["port"] / "batch", roots["jax"] / "batch")
    assert batch["images/dsA-LOC-2d-1.tiff"].shape == (20, 30)
    assert batch["images/dsA-LOC-2d-3.tiff"].shape == (32, 25)
    np.testing.assert_array_equal(batch["images/dsA-LOC-2d-0.tiff"],
                                  image[1])
    _same_tree(roots["port"] / "train", roots["jax"] / "train")
    cur.group_annotation_dirs(str(roots["port"] / "train"), {"dsB": "dsA"})
    jcur.group_annotation_dirs(str(roots["jax"] / "train"), {"dsB": "dsA"})
    train = _same_tree(roots["port"] / "train", roots["jax"] / "train")
    assert len(train["dsA/confidences.json"]) == 4


def test_organize_patches_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    img = _textured(rng, (300, 520))
    pd = cur.patch_and_hash(img, (img > 128).astype(np.uint16), 256)
    patches = {"src-LOC-2d-a.png": {
        "names": [f"p{i}" for i in range(len(pd["patches"]))],
        "patches": pd["patches"], "patch_masks": pd["patch_masks"]},
        "other.png": {"names": ["q"], "patches": [pd["patches"][0]]}}
    cur.organize_patches(patches, str(tmp_path / "port"))
    jcur.organize_patches(patches, str(tmp_path / "jax"))
    tree = _same_tree(tmp_path / "port", tmp_path / "jax")
    assert tree["src/masks/p0.tiff"].dtype == np.uint16


@pytest.fixture(scope="module")
def quality_filters():
    j_filter = jcur.PatchQualityFilter(encoder="resnet18", imsize=64)
    variables = _randomize(j_filter.variables, seed=2)
    j_filter = jcur.PatchQualityFilter(encoder="resnet18", imsize=64,
                                       variables=variables)
    port = cur.PatchQualityFilter(encoder="resnet18", imsize=64,
                                  state_dict=flax_to_torch(variables),
                                  device="cpu")
    return j_filter, port


def _patches(n=12):
    rng = np.random.default_rng(5)
    shapes = [(64, 64), (50, 70), (100, 90), (64, 80)]
    out = []
    for i in range(n):
        p = _textured(rng, shapes[i % len(shapes)])
        out.append(p if i % 3 else np.full(p.shape, 60 + i, np.uint8))
    return out


def test_quality_filter_scores_equal_jax(quality_filters):
    """Scores from the JAX filter's variables within SCORE_TOL; the same
    kept and rescued indices; no dependence on the batch split."""
    j_filter, port = quality_filters
    patches = _patches()
    want = j_filter.predict(patches, batch_size=8)
    got = port.predict(patches, batch_size=8)
    assert got.shape == want.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(port.predict(patches, batch_size=5), got,
                               rtol=0, atol=1e-6)
    thr = float(np.median(want))
    for keep_frac in (0.0, 0.5):
        k, d, _ = port.filter(patches, thr, keep_frac, seed=1)
        jk, jd, _ = j_filter.filter(patches, thr, keep_frac, seed=1)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(d, jd)
    # the resize alone: cv2's INTER_LINEAR on float32
    x = port._prep(patches[1:2])[0, 0]
    y = j_filter._prep(patches[1:2])[0, ..., 0]
    np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_quality_filter_default_init_is_seeded():
    a = cur.PatchQualityFilter("resnet18", imsize=32, seed=3, device="cpu")
    b = cur.PatchQualityFilter("resnet18", imsize=32, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    scores = a.predict(_patches(4))
    assert scores.shape == (4,) and np.isfinite(scores).all()


def test_curate_command_round_trip_equals_jax(tmp_path, capsys):
    """Every subcommand of both packages on the same inputs (the JAX
    test's flipbook flow, then dedup, split-stack, merge-batch and
    group-dirs): the same files."""
    rng = np.random.default_rng(6)
    vol = rng.integers(0, 255, (6, 32, 32), np.uint8)
    np.save(tmp_path / "vol.npy", vol)
    with open(tmp_path / "locs.json", "w") as f:
        json.dump([[3, 16, 16], [0, 4, 30]], f)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "msks").mkdir()
    base = _textured(rng, (256, 256))
    for i in range(2):
        img = np.tile(base, (2, 3))[:480, :700].copy()
        img[:, 500:] = _textured(rng, (480, 200))
        write_png(str(tmp_path / "imgs" / f"ds{i}-LOC-x.png"), img)
        write_png(str(tmp_path / "msks" / f"ds{i}-LOC-x.png"),
                  ((img > 150) * (i + 1)).astype(np.uint8))
    (tmp_path / "imgs" / "notes.txt").write_text("not an image")
    image, mask, attrs = _proof_inputs(rng)
    np.save(tmp_path / "im.npy", image)
    np.save(tmp_path / "mk.npy", mask)
    with open(tmp_path / "attrs.json", "w") as f:
        json.dump(attrs, f)
    with open(tmp_path / "conv.json", "w") as f:
        json.dump({"dsB": "dsA"}, f)

    for name, main in (("port", curate), ("jax", jax_curate)):
        out = tmp_path / name
        out.mkdir()
        main(["flipbooks", str(tmp_path / "vol.npy"),
              str(tmp_path / "locs.json"), str(out / "books.npy"),
              "--span", "3", "--size", "16"])
        main(["dedup", str(tmp_path / "imgs"), str(out / "dedup"),
              "--mask-dir", str(tmp_path / "msks"), "--crop-size", "256"])
        main(["split-stack", str(tmp_path / "im.npy"),
              str(tmp_path / "mk.npy"), str(tmp_path / "attrs.json"),
              str(out / "batch"), "--ignore", "0"])
        main(["merge-batch", str(out / "batch"), str(out / "train")])
        main(["group-dirs", str(out / "train"), str(tmp_path / "conv.json")])
    tree = _same_tree(tmp_path / "port", tmp_path / "jax")
    assert tree["books.npy"].shape == (2, 3, 16, 16)
    assert any(k.startswith("dedup/ds1/masks/") for k in tree)
    assert "train/dsA/confidences.json" in tree
    printed = capsys.readouterr().out
    assert "kept" in printed and "regrouped" in printed
