"""Port parity of the data pipeline: target creation within 1e-6 of the
JAX package's (OpenCV) heatmaps and offsets; each transform at fixed
parameters equal to the JAX package's, or for bilinear uint8 resampling
within one grey level on at most 1% of the pixels (cv2 rounds in fixed
point); Compose draws the same parameters from one seed; the loader's
batches per (seed, epoch) equal the JAX loader's with and without the
weighted sampler, and with one worker process the augmented examples
too; datasets, weights and addition; the PNG codec."""

import os

import pytest

for _dep in ("jax", "cv2"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import numpy as np
import torch

from empanada_tpu.data import DataLoader as JLoader
from empanada_tpu.data import create_dataset as j_create_dataset
from empanada_tpu.data.utils import sampler as j_sampler
from empanada_tpu.data.utils import target_creation as jtc
from empanada_tpu.data.utils import transforms as jt
from empanada_torch.data import DataLoader as TLoader
from empanada_torch.data import create_dataset as t_create_dataset
from empanada_torch.data import image_files
from empanada_torch.data.utils import sampler as t_sampler
from empanada_torch.data.utils import target_creation as ttc
from empanada_torch.data.utils import transforms as tt

RECIPE = [
    {"aug": "RandomScale", "scale_limit": [-0.9, 1]},
    {"aug": "PadIfNeeded", "min_height": 64, "min_width": 64},
    {"aug": "RandomCrop", "height": 64, "width": 64},
    {"aug": "Rotate", "limit": 180},
    {"aug": "RandomBrightnessContrast", "brightness_limit": 0.3,
     "contrast_limit": 0.3},
    {"aug": "HorizontalFlip"},
    {"aug": "VerticalFlip"},
    {"aug": "GaussNoise"},
    {"aug": "GaussianBlur"},
]
NORMS = {"mean": 0.5, "std": 0.15}


def _blobs(rng, h, w, n, dtype=np.int64):
    yy, xx = np.mgrid[:h, :w]
    mask = np.zeros((h, w), dtype)
    for k in range(1, n + 1):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, 12)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
    return mask


@pytest.mark.parametrize("n, sigma", [(0, 6), (1, 6), (9, 6), (9, 3),
                                      (25, 2.5)])
def test_heatmap_and_offsets_match_jax(n, sigma):
    mask = _blobs(np.random.default_rng(n), 53, 71, n)
    want_h, want_o = jtc.heatmap_and_offsets(mask, sigma)
    got_h, got_o = ttc.heatmap_and_offsets(mask, sigma)
    assert got_h.shape == want_h.shape and got_o.shape == want_o.shape
    assert got_h.dtype == want_h.dtype == np.float32
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_o, want_o, rtol=0, atol=1e-6)


def _assert_image_close(got, want, share=0.01):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, \
        (diff.max(), (diff > 0).mean())


@pytest.fixture
def pair():
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (61, 83, 1)).astype(np.uint8)
    mask = _blobs(rng, 61, 83, 8)
    return image, mask


@pytest.mark.parametrize("scale", [0.1, 0.37, 0.5, 0.91, 1.0, 1.63, 2.0])
def test_random_scale_at_fixed_scale(pair, scale):
    image, mask = pair
    j, t = jt.RandomScale(), tt.RandomScale()
    _assert_image_close(t.apply_image(image, scale),
                        j.apply_image(image, scale))
    np.testing.assert_array_equal(t.apply_mask(mask, scale),
                                  j.apply_mask(mask, scale))


@pytest.mark.parametrize("angle", [0.0, 13.7, -45.0, 90.0, 179.3, -120.5])
def test_rotate_at_fixed_angle(pair, angle):
    image, mask = pair
    j, t = jt.Rotate(limit=180), tt.Rotate(limit=180)
    _assert_image_close(t.apply_image(image, angle),
                        j.apply_image(image, angle), share=0.001)
    np.testing.assert_array_equal(t.apply_mask(mask, angle),
                                  j.apply_mask(mask, angle))


@pytest.mark.parametrize("name, params, call", [
    ("PadIfNeeded", {"min_height": 80, "min_width": 90}, {}),
    ("RandomCrop", {"height": 40, "width": 50}, {"hs": 0.3, "ws": 0.8}),
    ("CenterCrop", {"height": 40, "width": 50}, {}),
    ("RandomBrightnessContrast", {}, {"alpha": 1.2, "beta": -0.1}),
    ("HorizontalFlip", {}, {}),
    ("VerticalFlip", {}, {}),
    ("GaussianBlur", {}, {"ksize": 3}),
    ("GaussianBlur", {}, {"ksize": 5}),
    ("GaussianBlur", {}, {"ksize": 7}),
    ("Normalize", {"mean": 0.5, "std": 0.15}, {}),
    ("FactorPad", {"factor": 32}, {}),
])
def test_transform_at_fixed_params_is_equal(pair, name, params, call):
    image, mask = pair
    j = jt.AUGMENTATIONS[name](**params)
    t = tt.AUGMENTATIONS[name](**params)
    np.testing.assert_array_equal(t.apply_image(image, **call),
                                  j.apply_image(image, **call))
    if name not in ("RandomBrightnessContrast", "GaussianBlur", "Normalize"):
        np.testing.assert_array_equal(t.apply_mask(mask, **call),
                                      j.apply_mask(mask, **call))


def test_gauss_noise_and_helpers(pair):
    image, _ = pair
    noise = np.random.default_rng(1).normal(0, 5, image.shape).astype(
        np.float32)
    np.testing.assert_array_equal(tt.GaussNoise().apply_image(image, noise),
                                  jt.GaussNoise().apply_image(image, noise))
    np.testing.assert_array_equal(tt.factor_pad_numpy(image[..., 0], 16),
                                  jt.factor_pad_numpy(image[..., 0], 16))
    for f in (2, 4):
        _assert_image_close(tt.resize_by_factor(image[..., 0], f),
                            jt.resize_by_factor(image[..., 0], f))


def _recording(compose):
    """Wrap every transform's get_params to record what it drew."""
    log = []
    for t in compose.transforms:
        original = t.get_params

        def get_params(rng, image, original=original, name=type(t).__name__):
            params = original(rng, image)
            log.append((name, params))
            return params

        t.get_params = get_params
    return log


def test_compose_draws_the_same_parameters(pair):
    image, mask = pair
    j = jt.create_augmentations(RECIPE, norms=NORMS, seed=11)
    t = tt.create_augmentations(RECIPE, norms=NORMS, seed=11)
    j_log, t_log = _recording(j), _recording(t)
    for _ in range(6):
        want = j(image=image, mask=mask)
        got = t(image=image, mask=mask)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert got["image"].shape == want["image"].shape
    assert len(t_log) == len(j_log) > 6
    for (tn, tp), (jn, jp) in zip(t_log, j_log):
        assert tn == jn and set(tp) == set(jp)
        for key in tp:
            np.testing.assert_array_equal(tp[key], jp[key])
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def _write_set(root, counts, size=48, seed=0):
    rng = np.random.default_rng(seed)
    for si, n in enumerate(counts):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, f"s{si}", sub), exist_ok=True)
        for i in range(n):
            image_files.write_png(
                os.path.join(root, f"s{si}", "images", f"{i:02d}.png"),
                rng.integers(0, 256, (size, size)).astype(np.uint8))
            image_files.write_png(
                os.path.join(root, f"s{si}", "masks", f"{i:02d}.png"),
                _blobs(rng, size, size, 4, np.uint16))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _write_set(str(root / "a"), [7, 3])
    _write_set(str(root / "b"), [2, 4], seed=1)
    return root


@pytest.mark.parametrize("gamma", [0.7, None])
def test_datasets_weights_and_addition(data_dir, gamma):
    j = j_create_dataset("SingleClassInstanceDataset", str(data_dir / "a"),
                         weight_gamma=gamma)
    t = t_create_dataset("SingleClassInstanceDataset", str(data_dir / "a"),
                         weight_gamma=gamma)
    assert t.impaths == j.impaths and t.mskpaths == j.mskpaths
    j2 = j + j_create_dataset("SingleClassInstanceDataset",
                              str(data_dir / "b"), weight_gamma=gamma)
    t2 = t + t_create_dataset("SingleClassInstanceDataset",
                              str(data_dir / "b"), weight_gamma=gamma)
    assert t2.impaths == j2.impaths and len(t) == 10
    for a, b in ((t, j), (t2, j2)):
        if gamma is None:
            assert a.weights is None and b.weights is None
        else:
            np.testing.assert_allclose(a.weights, b.weights, rtol=1e-15)
    ex_t, ex_j = t[3], j[3]
    for key in ("image", "sem", "ctr_hmp", "offsets"):
        np.testing.assert_allclose(ex_t[key], ex_j[key], rtol=0, atol=1e-6)


def _loaders(data_dir, gamma, transforms_seed=None, workers=1):
    loaders = []
    for create, loader_cls, tf, smp in (
            (j_create_dataset, JLoader, jt, j_sampler),
            (t_create_dataset, TLoader, tt, t_sampler)):
        augs = None if transforms_seed is None else tf.create_augmentations(
            RECIPE, norms=NORMS, seed=transforms_seed)
        ds = create("SingleClassInstanceDataset", str(data_dir / "a"),
                    transforms=augs, weight_gamma=gamma)
        sampler = None if gamma is None else smp.WeightedRandomSampler(
            ds.weights, seed=3)
        loaders.append(loader_cls(ds, batch_size=3, sampler=sampler,
                                  shuffle=sampler is None, drop_last=True,
                                  num_workers=workers, seed=3))
    return loaders


@pytest.mark.parametrize("gamma", [0.7, None])
def test_batch_order_per_seed_and_epoch(data_dir, gamma):
    j, t = _loaders(data_dir, gamma, workers=2)
    assert len(t) == len(j) == 3
    for epoch in (0, 1, 4):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        want = [b["fname"] for b in j]
        got = [b["fname"] for b in t]
        assert got == want, epoch


def test_one_worker_augments_like_the_jax_loader(data_dir):
    """With one worker the examples of two epochs, augmentations
    included, are the JAX loader's (masks and targets from nearest
    resampling exactly; images within the stated tolerance)."""
    j, t = _loaders(data_dir, 0.7, transforms_seed=5, workers=1)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for bj, bt in zip(j, t):
            assert bt["fname"] == bj["fname"]
            assert isinstance(bt["image"], torch.Tensor)
            np.testing.assert_array_equal(bt["sem"].numpy(), bj["sem"])
            np.testing.assert_allclose(bt["offsets"].numpy(), bj["offsets"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(bt["ctr_hmp"].numpy(), bj["ctr_hmp"],
                                       rtol=0, atol=1e-6)
            # one grey level of the normalized image
            step = 1 / 255 / NORMS["std"]
            assert np.abs(bt["image"].numpy() - bj["image"]).max() \
                <= step * 1.001


def test_png_codec_round_trip_and_fallback_reader(tmp_path, monkeypatch):
    import cv2

    rng = np.random.default_rng(0)
    for dtype in (np.uint8, np.uint16):
        a = rng.integers(0, np.iinfo(dtype).max, (37, 53)).astype(dtype)
        path = str(tmp_path / "a.png")
        image_files.write_png(path, a)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      a)
        np.testing.assert_array_equal(image_files.read_png(path), a)
        cv2.imwrite(path, a)  # cv2 filters its rows
        np.testing.assert_array_equal(image_files.read_png(path), a)
    monkeypatch.setattr(image_files, "_reader", "png-codec")
    np.testing.assert_array_equal(image_files.read_mask(path),
                                  a.astype(np.int64))
    with pytest.raises(ValueError):
        image_files.write_png(path, a.astype(np.int32))


def test_unported_data_cases_raise():
    """Nothing of the data package is left unported: the boundary-contour
    dataset and target (their parity is in test_torch_bc.py) and the
    distributed samplers, which with no process group up draw as one
    process of rank 0, the JAX package's indices (more cases in
    test_torch_parallel.py)."""
    from empanada_torch.data import DATASETS, BCDataset

    assert DATASETS["BCDataset"] is BCDataset
    contour = ttc.seg_to_instance_bd(np.zeros((1, 4, 4)))
    assert contour.dtype == np.uint8 and not contour.any()
    ours = t_sampler.DistributedWeightedSampler(4, np.ones(4))
    theirs = j_sampler.DistributedWeightedSampler(4, np.ones(4),
                                                  num_replicas=1, rank=0)
    assert (ours.num_replicas, ours.rank) == (1, 0)
    assert list(ours) == list(theirs)
