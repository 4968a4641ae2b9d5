"""Port parity: empanada_torch.ops against the JAX package's ops on the CPU.

Inputs come from seeded numpy generators and go through both sides.
Float ops agree within 1e-5 absolute on O(1) values (float32 rounding of
the same formulas); integer outputs (centers, grouping, merges, runs)
must be identical.
"""

import pytest

# the JAX package's third-party dependencies: where only the port's are
# installed, these parity tests skip
for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from empanada_tpu.ops import postprocess as jpost
from empanada_tpu.ops import rle_device as jrle
from empanada_tpu.ops.pallas_group import group_pixels_pallas
from empanada_tpu.ops.resize import resize_bilinear as j_resize
from empanada_tpu.ops.sampling import point_sample as j_point_sample
from empanada_tpu.ops.sampling import (
    point_sample_full_grid as j_point_sample_full_grid,
)
from empanada_torch.ops import postprocess as tpost
from empanada_torch.ops import rle_device as trle
from empanada_torch.ops.group import LAUNCHES, group_pixels_plain
from empanada_torch.ops.resize import factor_pad
from empanada_torch.ops.resize import resize_bilinear as t_resize
from empanada_torch.ops.sampling import point_sample as t_point_sample
from empanada_torch.ops.sampling import (
    point_sample_full_grid as t_point_sample_full_grid,
)

FLOAT_TOL = 1e-5


def nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("src,dst", [((13, 7), (29, 22)), ((16, 16), (64, 64)),
                                     ((40, 33), (17, 9))])
def test_resize_bilinear_matches_jax(align_corners, src, dst):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + src + (3,)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), dst, align_corners))
    got = nchw_to_nhwc(t_resize(nhwc_to_nchw(x), dst, align_corners))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def test_resize_bilinear_2d_and_factor_pad():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((11, 6)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), (23, 15), True))
    got = t_resize(torch.from_numpy(x), (23, 15), True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)

    host = np.ones((3, 30, 27), np.uint8)
    padded, size = factor_pad(host, 16)
    assert isinstance(padded, np.ndarray) and padded.shape == (3, 32, 32)
    assert size == (30, 27) and padded[:, 30:].sum() == 0
    t_padded, _ = factor_pad(torch.ones(2, 1, 30, 27), 16)
    assert tuple(t_padded.shape) == (2, 1, 32, 32)


@pytest.mark.parametrize("h,w", [(8, 8), (13, 10)])
def test_point_sample_matches_jax(h, w):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    coords = rng.random((2, 64, 2)).astype(np.float32)
    coords[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]  # border ring
    want = np.asarray(j_point_sample(jnp.asarray(feats), jnp.asarray(coords)))
    got = t_point_sample(nhwc_to_nchw(feats), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("scale", [2, 4])
def test_point_sample_full_grid_matches_jax(scale):
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 9, 12, 3)).astype(np.float32)
    want = np.asarray(j_point_sample_full_grid(jnp.asarray(feats), scale))
    got = nchw_to_nhwc(t_point_sample_full_grid(nhwc_to_nchw(feats), scale))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def test_median_prob_harden_match_jax():
    rng = np.random.default_rng(5)
    win = rng.standard_normal((5, 2, 7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tpost.median_small(torch.from_numpy(win), 0).numpy(),
        np.asarray(jpost.median_small(jnp.asarray(win), 0)))
    for c in (1, 3):
        logits = rng.standard_normal((2, 6, 5, c)).astype(np.float32)
        want_p = np.asarray(jpost.logits_to_prob(jnp.asarray(logits)))
        got_p = tpost.logits_to_prob(nhwc_to_nchw(logits))
        np.testing.assert_allclose(nchw_to_nhwc(got_p), want_p, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            tpost.harden_semantic(got_p, 0.4).numpy(),
            np.asarray(jpost.harden_semantic(jnp.asarray(nchw_to_nhwc(got_p)),
                                             0.4)))


def _heatmaps(rng, kind, h=24, w=20):
    if kind == "none":
        return np.zeros((h, w), np.float32)
    hm = rng.random((h, w)).astype(np.float32)
    if kind == "ties":  # quantized: plateaus and equal peak scores
        hm = np.round(hm * 4) / 4
    return hm


@pytest.mark.parametrize("kind", ["random", "ties", "none"])
@pytest.mark.parametrize("max_centers", [4, 64, 1024])
@pytest.mark.parametrize("nms_kernel", [3, 7])
def test_find_instance_centers_exact(kind, max_centers, nms_kernel):
    rng = np.random.default_rng(6)
    hm = _heatmaps(rng, kind)
    c_j, v_j = jpost.find_instance_centers(jnp.asarray(hm), 0.1, nms_kernel,
                                           max_centers)
    c_t, v_t = tpost.find_instance_centers(torch.from_numpy(hm)[None], 0.1,
                                           nms_kernel, max_centers)
    np.testing.assert_array_equal(c_t[0].numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j))
    if kind == "none":
        assert not v_t.any()


def _group_inputs(rng, k, h, w, valid_frac, quantize):
    centers = rng.integers(0, h, (k, 2)).astype(np.int32)
    valid = rng.random(k) < valid_frac
    offsets = (rng.standard_normal((h, w, 2)) * 6).astype(np.float32)
    if quantize:  # half-pixel offsets put pixels on exact distance ties
        offsets = np.round(offsets * 2) / 2
    return centers, valid, offsets


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("step", [1.0, 4.0])
@pytest.mark.parametrize("valid_frac,quantize",
                         [(0.5, False), (0.5, True), (1.0, True), (0.0, False)])
def test_group_pixels_exact_vs_jax_and_pallas(k, step, valid_frac, quantize):
    rng = np.random.default_rng(7)
    h, w = 32, 48
    centers, valid, offsets = _group_inputs(rng, k, h, w, valid_frac,
                                            quantize)
    want = np.asarray(jpost.group_pixels(
        jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(offsets),
        step=step, use_pallas=False))
    launches = LAUNCHES["group_pixels"]
    got = tpost.group_pixels(torch.from_numpy(centers)[None],
                             torch.from_numpy(valid)[None],
                             torch.from_numpy(offsets)[None], step)[0]
    assert LAUNCHES["group_pixels"] == launches  # CPU: plain version only
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if valid.any():
        pallas = np.asarray(group_pixels_pallas(
            jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(offsets),
            step=step, interpret=True))
        np.testing.assert_array_equal(got.numpy(), pallas)
    else:
        assert not got.any()


def test_group_pixels_batched_slices_independent():
    """A batch mixing full, sparse and empty slices equals the per-slice
    results."""
    rng = np.random.default_rng(8)
    ins = [_group_inputs(rng, 64, 16, 24, f, False) for f in (1.0, 0.1, 0.0)]
    c, v, o = (torch.from_numpy(np.stack(a)) for a in zip(*ins))
    batched = group_pixels_plain(c, v, o, 4.0)
    for i, (ci, vi, oi) in enumerate(ins):
        want = np.asarray(jpost.group_pixels(
            jnp.asarray(ci), jnp.asarray(vi), jnp.asarray(oi), step=4.0,
            use_pallas=False))
        np.testing.assert_array_equal(batched[i].numpy(), want)


def _merge_inputs(rng, h, w, scale, num_classes, max_centers):
    sem = rng.integers(0, num_classes, (h, w)).astype(np.int32)
    ins_c = rng.integers(0, max_centers + 1, (h // scale, w // scale))
    ins_c = np.where(rng.random(ins_c.shape) < 0.3, 0, ins_c).astype(np.int32)
    return sem, ins_c


@pytest.mark.parametrize("label_divisor", [1000, 20000])
@pytest.mark.parametrize("num_classes,thing_list,stuff_area",
                         [(2, [1], 0), (3, [1, 2], 5), (4, [2], 40)])
def test_merges_exact(label_divisor, num_classes, thing_list, stuff_area):
    rng = np.random.default_rng(9)
    max_centers, scale, h, w = 64, 4, 32, 40
    sem, ins_c = _merge_inputs(rng, h, w, scale, num_classes, max_centers)
    table = np.zeros(num_classes, bool)
    table[thing_list] = True
    t_table = torch.from_numpy(table)

    want_c = np.asarray(jpost.merge_semantic_and_instance_coarse(
        jnp.asarray(sem), jnp.asarray(ins_c), scale, label_divisor,
        jnp.asarray(table), stuff_area, 0, max_centers, num_classes))
    got_c = tpost.merge_semantic_and_instance_coarse(
        torch.from_numpy(sem)[None], torch.from_numpy(ins_c)[None], scale,
        label_divisor, t_table, stuff_area, 0, max_centers, num_classes)
    np.testing.assert_array_equal(got_c[0].numpy(), want_c)

    ins = np.repeat(np.repeat(ins_c, scale, 0), scale, 1)
    ins[::3] = rng.integers(0, max_centers + 1, ins[::3].shape)
    want = np.asarray(jpost.merge_semantic_and_instance(
        jnp.asarray(sem), jnp.asarray(ins), label_divisor,
        jnp.asarray(table), stuff_area, 0, max_centers, num_classes))
    got = tpost.merge_semantic_and_instance(
        torch.from_numpy(sem)[None], torch.from_numpy(ins)[None],
        label_divisor, t_table, stuff_area, 0, max_centers, num_classes)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert want.max() >= max(thing_list) * label_divisor


@pytest.mark.parametrize("label_divisor", [1000, 20000])
def test_get_panoptic_segmentation_exact(label_divisor):
    rng = np.random.default_rng(10)
    h, w, c = 24, 32, 3
    logits = rng.standard_normal((h, w, c)).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ctr = rng.random((h, w)).astype(np.float32)
    off = (rng.standard_normal((h, w, 2)) * 4).astype(np.float32)
    kw = dict(thing_list=[1, 2], label_divisor=label_divisor, stuff_area=20,
              nms_kernel=5, max_centers=64)
    want = np.asarray(jpost.get_panoptic_segmentation(
        jnp.asarray(prob), jnp.asarray(ctr), jnp.asarray(off), **kw))
    got = tpost.get_panoptic_segmentation(
        nhwc_to_nchw(prob[None]), torch.from_numpy(ctr)[None],
        torch.from_numpy(off)[None], **kw)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("max_runs", [16 * 24, 50, 7])
@pytest.mark.parametrize("fg_frac", [0.5, 0.0, 1.0])
def test_extract_runs_exact(max_runs, fg_frac):
    rng = np.random.default_rng(11)
    pans = [np.where(rng.random((16, 24)) < fg_frac,
                     rng.integers(1, 4, (16, 24)), 0).astype(np.int32)
            for _ in range(3)]
    batch = torch.from_numpy(np.stack(pans))
    got_fg = [t.numpy() for t in trle.extract_fg_runs(batch, max_runs)]
    got_all = [t.numpy() for t in trle.extract_runs(batch, max_runs)]
    for i, pan in enumerate(pans):
        want_fg = [np.asarray(a) for a in
                   jrle.extract_fg_runs(jnp.asarray(pan), max_runs)]
        want_all = [np.asarray(a) for a in
                    jrle.extract_runs(jnp.asarray(pan), max_runs)]
        for got, want in zip(got_fg, want_fg):
            np.testing.assert_array_equal(got[i], want)
        for got, want in zip(got_all, want_all):
            np.testing.assert_array_equal(got[i], want)
