"""The port's C++ host core against its plain versions and the JAX
package.

For every entry point of ``empanada_torch/core/_native/core.cpp`` the
same seeded numpy inputs go through (a) the port's native path, (b) the
port's numpy path (``native.numpy_host_half()``) and (c) the JAX
package's function, and every output must be exactly equal: they are
integers, and the IoU floats of ``boxes`` are the same division. A case
that the native path must decline (non-canonical input, float boxes, a
dtype the fill does not cover) has to leave the entry point's call count
alone and still give the same answer.

Also here: the library builds from a clean directory with g++ alone, a
broken compiler raises, EMPANADA_TORCH_NO_NATIVE gives the numpy path,
and host threads calling the library at once get the serial answers.

The JAX package's library is this file's own build (``jax_library``):
the JAX loader builds ``libetpu_core.so`` in place with ``make``, and
test processes that load it while another one writes it get no library
at all, so this file builds a private copy, under a file lock, and
points the loader at it while its tests run.
"""

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.core import boxes as jax_boxes
from empanada_tpu.core import ccl as jax_ccl
from empanada_tpu.core import ccl3d as jax_ccl3d
from empanada_tpu.core import fill as jax_fill
from empanada_tpu.core import native as jax_native
from empanada_tpu.core import ranges as jax_ranges
from empanada_tpu.core import rle as jax_rle
from empanada_tpu.inference import matcher as jax_matcher
from empanada_torch import native_build
from empanada_torch.core import boxes, ccl, ccl3d, fill, native, ranges, rle
from empanada_torch.inference import matcher

ROOT = Path(__file__).resolve().parents[1]
WRAPPERS = ("coverage_ranges", "ranges_intersection", "pair_intersections",
            "kway_merge_ranges", "kway_vote", "kway_union_sr",
            "kway_union_batch", "rle_union", "box_overlap_pairs", "runs_ccl",
            "runs_ccl3d", "fill_runs", "encode_runs")


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's host core built from a copy of its ``core.cpp``
    and ``Makefile`` in a directory of the temporary directory named by
    their hash (``make`` there, as ``tests/test_native_build.py`` builds
    it, once, under an exclusive ``fcntl`` lock on that directory), and
    the JAX loader pointed at it for this module (its library and
    directory, with a fresh load), restored afterwards. Nothing of this
    file runs ``make`` in ``empanada_tpu/core/_native/``."""
    src = ROOT / "empanada_tpu" / "core" / "_native"
    files = ("core.cpp", "Makefile")
    key = hashlib.sha256(b"".join((src / f).read_bytes()
                                  for f in files)).hexdigest()[:16]
    build = Path(tempfile.gettempdir()) / f"empanada_tpu_core_{key}"
    build.mkdir(exist_ok=True)
    lib = build / "libetpu_core.so"
    with open(build / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            work = Path(tempfile.mkdtemp(dir=build))
            for f in files:
                shutil.copy(src / f, work / f)
            subprocess.run(["make", "-C", str(work), "-s"], check=True,
                           capture_output=True, timeout=120)
            for f in files:
                os.replace(work / f, build / f)
            os.replace(work / lib.name, lib)
            shutil.rmtree(work)
    saved = (jax_native._NATIVE_DIR, jax_native._LIB_PATH, jax_native._lib,
             jax_native._tried)
    jax_native._NATIVE_DIR, jax_native._LIB_PATH = str(build), str(lib)
    jax_native._lib, jax_native._tried = None, False
    try:
        assert jax_native.get_lib() is not None, lib
        yield lib
    finally:
        (jax_native._NATIVE_DIR, jax_native._LIB_PATH, jax_native._lib,
         jax_native._tried) = saved


def assert_same(got, want, what=""):
    """Exact equality of nested tuples / lists / dicts of arrays and
    numbers (None only equals None)."""
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for key in want:
            assert_same(got[key], want[key], f"{what}[{key!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
        assert np.asarray(got).shape == np.asarray(want).shape, what


def three_ways(port_fn, jax_fn, args, entry_points, declines=False,
               canon=lambda out: out):
    """Run ``port_fn(*args())`` on the native path, then on the numpy
    path, then ``jax_fn(*args())``; hold all three equal (after
    ``canon``, for outputs whose order is free) and return the native
    result. ``args`` builds fresh arguments for each run. The native run
    must call each of ``entry_points`` (or none of them, where it has to
    decline); the numpy run must call nothing."""
    native.reset_calls()
    got = port_fn(*args())
    calls = dict(native.CALLS)
    for name in entry_points:
        assert (calls[name] == 0) == declines, (name, calls)
    native.reset_calls()
    with native.numpy_host_half():
        assert native.get_lib() is None
        plain = port_fn(*args())
    assert not any(native.CALLS.values()), native.CALLS
    want = jax_fn(*args())
    assert_same(canon(got), canon(plain), "native vs numpy")
    assert_same(canon(got), canon(want), "port vs JAX package")
    return got


def with_host_half(host_half, fn, required=()):
    """``fn()`` with the host half named: "native" (the default path;
    every entry point in ``required`` must have been called) or "numpy"
    (asked for; the library must not have been called)."""
    native.reset_calls()
    if host_half == "numpy":
        with native.numpy_host_half():
            out = fn()
        assert not any(native.CALLS.values()), native.CALLS
        return out
    out = fn()
    for name in required:
        assert native.CALLS[name] > 0, (name, native.CALLS)
    return out


def random_ranges(rng, n, span=400, canonical=True):
    """(n', 2) int64 [start, end) ranges: canonical (sorted, disjoint,
    some touching) or merely start-sorted with overlaps."""
    if n == 0:
        return np.zeros((0, 2), np.int64)
    if canonical:
        cuts = np.sort(rng.choice(span, size=2 * n, replace=False))
        out = cuts.reshape(-1, 2).astype(np.int64)
        out[1::3, 0] = out[:-1:3, 1][:len(out[1::3])]  # touch the one before
        return out
    starts = np.sort(rng.integers(0, span, n))
    return np.stack([starts, starts + rng.integers(1, 40, n)],
                    axis=1).astype(np.int64)


def random_rle(rng, n, span=400):
    r = random_ranges(rng, n, span)
    return r[:, 0].copy(), (r[:, 1] - r[:, 0]).copy()


# --- coverage_ranges, ranges_intersection -----------------------------------

COVERAGE_CASES = {
    "empty": (np.zeros((0, 2), np.int64), 1),
    "single": (np.array([[3, 9]]), 1),
    "single-thr2": (np.array([[3, 9]]), 2),
    "touching": (np.array([[0, 5], [5, 9], [9, 12]]), 1),
    "touching-thr2": (np.array([[0, 5], [0, 9], [5, 9], [9, 12]]), 2),
    "nested": (np.array([[0, 20], [2, 6], [4, 10], [15, 30]]), 2),
    "random-thr1": (random_ranges(np.random.default_rng(0), 150, 600,
                                  False), 1),
    "random-thr2": (random_ranges(np.random.default_rng(1), 150, 600,
                                  False), 2),
    "random-thr3": (random_ranges(np.random.default_rng(2), 150, 600,
                                  False), 3),
}


@pytest.mark.parametrize("case", COVERAGE_CASES)
def test_coverage_ranges(case):
    r, thr = COVERAGE_CASES[case]
    got = three_ways(ranges._coverage_ranges, jax_ranges._coverage_ranges,
                     lambda: (r.copy(), thr), ["coverage_ranges"],
                     declines=len(r) == 0)
    assert got.dtype == np.int64 and got.shape[1] == 2
    if len(r):
        assert_same(native.coverage_ranges(r, thr),
                    jax_native.coverage_ranges(r, thr))


INTERSECTION_CASES = {
    "empty-a": (0, 5), "empty-b": (5, 0), "single": (1, 1),
    "small": (7, 9), "large": (150, 90),
}


@pytest.mark.parametrize("case", INTERSECTION_CASES)
def test_ranges_intersection(case):
    na, nb = INTERSECTION_CASES[case]
    rng = np.random.default_rng(3)
    a, b = random_ranges(rng, na), random_ranges(rng, nb)
    got = three_ways(ranges.ranges_intersection,
                     jax_ranges.ranges_intersection, lambda: (a, b),
                     ["ranges_intersection"], declines=0 in (na, nb))
    dense = np.zeros(400, bool), np.zeros(400, bool)
    for d, r in zip(dense, (a, b)):
        for s, e in r:
            d[s:e] = True
    assert got == int((dense[0] & dense[1]).sum())


def test_ranges_intersection_touching_is_zero():
    a, b = np.array([[0, 5], [9, 12]]), np.array([[5, 9], [12, 20]])
    assert three_ways(ranges.ranges_intersection,
                      jax_ranges.ranges_intersection, lambda: (a, b),
                      ["ranges_intersection"]) == 0


# --- pair_intersections -----------------------------------------------------

def _instance_set(rng, n, empty_at=None):
    starts, runs = [], []
    for i in range(n):
        s, r = random_rle(rng, 0 if i == empty_at else int(
            rng.integers(1, 30)))
        starts.append(s)
        runs.append(r)
    return starts, runs


@pytest.mark.parametrize("case", ["no-pairs", "all-pairs", "self",
                                  "empty-instance", "single-pair"])
def test_pair_intersections(case):
    rng = np.random.default_rng(4)
    sa, ra = _instance_set(rng, 12, empty_at=3 if case == "empty-instance"
                           else None)
    sb, rb = (sa, ra) if case == "self" else _instance_set(rng, 9)
    rows, cols = np.meshgrid(np.arange(len(sa)), np.arange(len(sb)),
                             indexing="ij")
    rows, cols = rows.ravel(), cols.ravel()
    if case == "no-pairs":
        rows, cols = rows[:0], cols[:0]
    elif case == "single-pair":
        rows, cols = rows[5:6], cols[5:6]
    got = three_ways(rle.rle_pairwise_intersections,
                     jax_rle.rle_pairwise_intersections,
                     lambda: (sa, ra, sb, rb, rows, cols),
                     ["pair_intersections"], declines=case == "no-pairs")
    assert got.dtype == np.int64 and got.shape == rows.shape
    for k in range(0, len(rows), 7):
        i, j = rows[k], cols[k]
        assert got[k] == rle.rle_intersection(sa[i], ra[i], sb[j], rb[j])
    if case in ("all-pairs", "self"):
        assert got.sum() > 0


# --- kway_merge_ranges, kway_vote -------------------------------------------

def _range_lists(case):
    rng = np.random.default_rng(5)
    if case == "canonical":
        return [random_ranges(rng, n) for n in (20, 1, 35, 8)]
    if case == "with-empty":
        return [random_ranges(rng, n) for n in (20, 0, 35)]
    if case == "single-list":
        return [random_ranges(rng, 25)]
    if case == "single-range":
        return [np.array([[4, 9]]), np.array([[6, 11]])]
    if case == "touching":
        return [np.array([[0, 5], [10, 15]]), np.array([[5, 10]]),
                np.array([[15, 20], [30, 31]])]
    if case == "ties":
        return [np.array([[0, 5], [7, 9]]), np.array([[0, 3], [7, 20]]),
                np.array([[0, 9]])]
    if case == "overlapping":   # start-sorted, not disjoint
        return [random_ranges(rng, n, canonical=False) for n in (20, 30)]
    if case == "unsorted":
        return [random_ranges(rng, 20)[::-1].copy(), random_ranges(rng, 9)]
    raise KeyError(case)


RANGE_LIST_CASES = ["canonical", "with-empty", "single-list", "single-range",
                    "touching", "ties", "overlapping", "unsorted"]


@pytest.mark.parametrize("case", RANGE_LIST_CASES)
def test_kway_merge_ranges(case):
    """concat_sort_ranges: the native merge for start-sorted lists (ties
    keep concatenation order), the argsort for one list or an unsorted
    one."""
    lists = _range_lists(case)
    declines = case in ("single-list", "unsorted")
    got = three_ways(ranges.concat_sort_ranges, jax_ranges.concat_sort_ranges,
                     lambda: ([r.copy() for r in lists],),
                     ["kway_merge_ranges"], declines=declines)
    assert len(got) == sum(len(r) for r in lists)
    assert np.all(got[1:, 0] >= got[:-1, 0])


@pytest.mark.parametrize("thr", [1, 2, 3])
@pytest.mark.parametrize("case", RANGE_LIST_CASES)
def test_kway_vote(case, thr):
    """vote_by_ranges (a join at thr 1): one native heap pass for
    canonical lists; lists that overlap or are unsorted must decline it
    and take the generic sort + sweep, with the same answer."""
    lists = _range_lists(case)
    n_lists = sum(len(r) > 0 for r in lists)
    declines = case in ("overlapping", "unsorted") or \
        (thr > 1 and n_lists < thr)
    got = three_ways(ranges.vote_by_ranges, jax_ranges.vote_by_ranges,
                     lambda: ([r.copy() for r in lists], thr),
                     ["kway_vote"], declines=declines)
    depth = np.zeros(700, np.int64)
    for r in lists:
        for s, e in r:
            depth[s:e] += 1
    # fewer non-empty sources than votes asked for: empty by definition
    want = np.flatnonzero(depth >= thr) if thr == 1 or n_lists >= thr \
        else np.zeros(0, np.int64)
    filled = np.zeros(700, bool)
    for s, e in got:
        filled[s:e] = True
    np.testing.assert_array_equal(np.flatnonzero(filled), want)
    assert np.all(got[1:, 0] > got[:-1, 1])  # maximal: no touching ranges


# --- rle_union, kway_union_sr, kway_union_batch -----------------------------

@pytest.mark.parametrize("case", ["canonical", "touching", "empty-b",
                                  "one-argument", "non-canonical"])
def test_rle_union(case):
    rng = np.random.default_rng(6)
    sa, ra = random_rle(rng, 30)
    sb, rb = random_rle(rng, 20)
    if case == "touching":
        sa, ra = np.array([0, 10]), np.array([5, 5])
        sb, rb = np.array([5, 15]), np.array([5, 2])
    elif case == "empty-b":
        sb, rb = sb[:0], rb[:0]
    elif case == "non-canonical":
        sa, ra = sa[::-1].copy(), ra[::-1].copy()
    args = (sa, ra) if case == "one-argument" else (sa, ra, sb, rb)
    got = three_ways(rle.merge_rles, jax_rle.merge_rles, lambda: args,
                     ["rle_union"],
                     declines=case in ("one-argument", "non-canonical"))
    if case == "touching":
        assert_same(got, (np.array([0]), np.array([17])))


def _attrs(rng, n_runs, canon_flag=True, reverse=False):
    """An instance attr dict whose RLE is minimal (no touching runs), as
    the trackers' are: a one-member group passes through a union
    untouched on every path."""
    s, r = rle.rle_encode(np.unique(rng.integers(0, 400, 2 * n_runs)))
    if reverse:
        s, r = s[::-1].copy(), r[::-1].copy()
    lo = int(s.min()) if len(s) else 0
    hi = int((s + r).max()) if len(s) else 1
    attrs = {"box": (lo // 20, lo % 20, hi // 20 + 1, hi % 20 + 1),
             "starts": s, "runs": r}
    if canon_flag and not reverse:
        attrs["_canon"] = (s, r, int(r.sum()), s)
    return attrs


def _strip(merged):
    """An attr dict (or a list of them) without the ``_canon`` cache."""
    if isinstance(merged, list):
        return [_strip(m) for m in merged]
    return {k: v for k, v in merged.items() if k != "_canon"}


@pytest.mark.parametrize("case", ["flagged", "checked", "with-empty",
                                  "pair", "non-canonical"])
def test_kway_union_sr(case):
    """merge_attrs_many: the native k-way starts/runs union for
    canonical members (flagged by ``_canon`` or checked), the generic
    join for a member that is not."""
    rng = np.random.default_rng(7)
    members = [_attrs(rng, n, canon_flag=case != "checked")
               for n in ((25, 10) if case == "pair" else (25, 10, 40, 3))]
    if case == "with-empty":
        members[1] = _attrs(rng, 0)
    if case == "non-canonical":
        members[2] = _attrs(rng, 30, reverse=True)
    got = three_ways(matcher.merge_attrs_many, jax_matcher.merge_attrs_many,
                     lambda: (list(members),), ["kway_union_sr"],
                     declines=case == "non-canonical", canon=_strip)
    s, r = got["starts"], got["runs"]
    assert np.all(s[1:] > s[:-1] + r[:-1])
    assert_same(got["_canon"][:2], (s, r))
    one = members[:1]
    assert matcher.merge_attrs_many(one) is one[0]


@pytest.mark.parametrize("case", ["groups", "one-group", "non-canonical"])
def test_kway_union_batch(case):
    """merge_attrs_batch == [merge_attrs_many(g) for g in groups], in
    one native crossing when every member is canonical."""
    rng = np.random.default_rng(8)
    sizes = [(3,)] if case == "one-group" else [(2, 3, 1), (4,), (2, 2)][:3]
    groups = [[_attrs(rng, int(rng.integers(1, 40))) for _ in range(k)]
              for ks in sizes for k in ks]
    if case == "non-canonical":
        groups[1][0] = _attrs(rng, 12, reverse=True)
    got = three_ways(matcher.merge_attrs_batch, jax_matcher.merge_attrs_batch,
                     lambda: ([list(g) for g in groups],),
                     ["kway_union_batch"], declines=case == "non-canonical",
                     canon=_strip)
    assert len(got) == len(groups)
    for merged, group in zip(got, groups):
        assert_same(_strip(merged), _strip(matcher.merge_attrs_many(group)))


# --- box_overlap_pairs ------------------------------------------------------

def _boxes(rng, n, ndim, size, dtype=np.int64, extent=300):
    lo = rng.integers(0, extent, (n, ndim))
    return np.concatenate([lo, lo + rng.integers(1, size, (n, ndim))],
                          axis=1).astype(dtype)


def _sorted_pairs(out):
    rows, cols, iou, inter = out
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], iou[order], inter[order]


BOX_CASES = {
    # name: (n, m or None for self pairs, ndim, box size, dtype)
    "2d-two-sets": (300, 260, 2, 40, np.int64),
    "3d-two-sets": (300, 260, 3, 60, np.int64),
    "3d-self": (280, None, 3, 60, np.int64),
    "int32": (300, 260, 2, 40, np.int32),
    # every box overlaps every other: more pairs than the first buffer
    # holds, so the wrapper grows it and calls again
    "all-overlap": (300, 260, 2, 10 ** 6, np.int64),
    "float": (300, 260, 2, 40, np.float64),
    "small": (40, 30, 3, 60, np.int64),
}


@pytest.mark.parametrize("case", BOX_CASES)
def test_box_overlap_pairs(case):
    """box_iou_pairs above 2^16 candidate pairs takes the native bucketed
    sweep; float boxes and small inputs take the numpy blocks. The two
    emit the pairs in different orders, so they are compared sorted."""
    n, m, ndim, size, dtype = BOX_CASES[case]
    rng = np.random.default_rng(9)
    b1 = _boxes(rng, n, ndim, size, dtype)
    b2 = None if m is None else _boxes(rng, m, ndim, size, dtype)
    if dtype == np.float64:
        b1[:, ndim:] -= 0.25  # thin overlaps that truncation would drop
    assert (n * (m or n) > 1 << 16) == (case != "small")
    got = three_ways(boxes.box_iou_pairs, jax_boxes.box_iou_pairs,
                     lambda: (b1, b2), ["box_overlap_pairs"],
                     declines=case in ("float", "small"),
                     canon=_sorted_pairs)
    if case == "all-overlap":
        assert len(got[0]) == n * m
    if case not in ("float", "small"):
        # same order as the JAX package's library, not only the same set
        assert_same(native.box_overlap_pairs(b1, b2),
                    jax_native.box_overlap_pairs(b1, b2))
    if case == "float":
        assert native.box_overlap_pairs(b1, b2) is None
    iou_dense, inter_dense = boxes.box_iou_dense(b1, b2,
                                                 return_intersection=True)
    rows, cols, iou, inter = got
    assert len(rows) == int((inter_dense > 0).sum()) > 0
    np.testing.assert_array_equal(inter, inter_dense[rows, cols])
    assert np.all(iou == inter / (boxes.box_area(b1)[rows] + boxes.box_area(
        b1 if b2 is None else b2)[cols] - inter))


def test_box_overlap_pairs_grows_its_buffer():
    rng = np.random.default_rng(10)
    b1 = _boxes(rng, 300, 2, 10 ** 6)
    native.reset_calls()
    pairs, inter = native.box_overlap_pairs(b1)
    assert len(pairs) == 300 * 300 and native.CALLS["box_overlap_pairs"] == 2
    assert np.all(inter > 0)


# --- encode_runs, runs_ccl, runs_ccl3d --------------------------------------

def _label_image(rng, shape, n_values=3, density=0.55):
    img = rng.integers(1, n_values + 1, shape)
    img[rng.random(shape) > density] = 0
    return img.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "one-row", "one-column",
                                  "constant", "int64"])
def test_encode_runs(case):
    rng = np.random.default_rng(11)
    img = {"random": _label_image(rng, (23, 31)),
           "one-row": _label_image(rng, (1, 50)),
           "one-column": _label_image(rng, (40, 1)),
           "constant": np.full((6, 9), 7, np.int32),
           "int64": _label_image(rng, (12, 17)).astype(np.int64)}[case]
    starts, ends, values = three_ways(ccl.image_to_runs,
                                      jax_ccl.image_to_runs, lambda: (img,),
                                      ["encode_runs_i32"])
    assert starts.dtype == ends.dtype == values.dtype == np.int64
    back = np.repeat(values, ends - starts).reshape(img.shape)
    np.testing.assert_array_equal(back, img)
    assert np.all(starts // img.shape[1] == (ends - 1) // img.shape[1])


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", ["binary", "multi-value", "empty",
                                  "single-run", "row-gaps"])
def test_runs_ccl(case, connectivity):
    rng = np.random.default_rng(12)
    img = {"binary": _label_image(rng, (30, 41), 1),
           "multi-value": _label_image(rng, (30, 41), 3),
           "empty": np.zeros((5, 7), np.int32),
           "single-run": np.pad(np.ones((1, 4), np.int32), 2),
           "row-gaps": _label_image(rng, (30, 41), 2)}[case]
    if case == "row-gaps":
        img[::3] = 0

    def labels_of(mod):
        s, e, v = mod.image_to_runs(img)
        fg = v != 0
        return lambda: (s[fg], e[fg], v[fg], img.shape[1], connectivity)

    labels, n = three_ways(ccl.runs_connected_components,
                           jax_ccl.runs_connected_components, labels_of(ccl),
                           ["runs_ccl"], declines=case == "empty")
    assert labels.dtype == np.int32 and n == (labels.max() if len(labels)
                                              else 0)
    got = three_ways(ccl.connected_components_2d,
                     jax_ccl.connected_components_2d,
                     lambda: (img, connectivity), [])
    if case == "binary":
        structure = np.ones((3, 3)) if connectivity == 8 else None
        want, n_want = ndimage.label(img, structure=structure)
        np.testing.assert_array_equal(got, want)
        assert n == n_want


@pytest.mark.parametrize("connectivity", [6, 26])
@pytest.mark.parametrize("case", ["binary", "multi-value", "empty",
                                  "one-voxel", "sparse"])
def test_runs_ccl3d(case, connectivity):
    """core/ccl3d.connected_components_3d: native == the python
    union-find == the JAX package's == scipy.ndimage.label (binary)."""
    rng = np.random.default_rng(13)
    vol = {"binary": _label_image(rng, (7, 12, 15), 1, 0.4),
           "multi-value": _label_image(rng, (7, 12, 15), 3, 0.6),
           "empty": np.zeros((3, 4, 5), np.int32),
           "one-voxel": np.pad(np.ones((1, 1, 1), np.int32), 1),
           "sparse": _label_image(rng, (9, 10, 11), 1, 0.12)}[case]
    got = three_ways(ccl3d.connected_components_3d,
                     jax_ccl3d.connected_components_3d,
                     lambda: (vol, connectivity), ["runs_ccl3d"],
                     declines=case == "empty")
    assert got.dtype == np.uint32 and got.shape == vol.shape
    np.testing.assert_array_equal(got > 0, vol > 0)
    if case != "multi-value":
        structure = np.ones((3, 3, 3)) if connectivity == 26 else None
        want, _ = ndimage.label(vol, structure=structure)
        np.testing.assert_array_equal(got, want)
    else:
        # components never join two values
        for label in range(1, int(got.max()) + 1):
            assert len(np.unique(vol[got == label])) == 1


def test_runs_ccl3d_refuses_runs_outside_the_volume():
    with pytest.raises(ValueError, match="outside"):
        native.runs_ccl3d([0, 500], [3, 503], [1, 1], 2, 3, 4)


@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("threshold", [None, 1, 4, 9])
def test_size_threshold_3d(threshold, relabel):
    rng = np.random.default_rng(14)
    seg = ccl3d.connected_components_3d(_label_image(rng, (6, 11, 13), 2,
                                                     0.5), 6)
    got = ccl3d.size_threshold_3d(seg, threshold, relabel)
    assert_same(got, jax_ccl3d.size_threshold_3d(seg, threshold, relabel))
    assert got.dtype == seg.dtype
    if threshold == 9:
        assert 0 < (got > 0).sum() < (seg > 0).sum()


# --- fill_runs --------------------------------------------------------------

FILL_SHAPE = (6, 20, 30)


def _fill_instances(rng, n=12):
    size = int(np.prod(FILL_SHAPE))
    cuts = np.sort(rng.choice(np.arange(1, size), 400, replace=False))
    starts, ends = cuts[:-1], cuts[1:]
    keep = rng.random(len(starts)) < 0.5
    starts, ends = starts[keep], ends[keep]
    owner = rng.integers(0, n, len(starts))
    return {101 + k: {"box": (0, 0, 0) + FILL_SHAPE,
                      "starts": starts[owner == k],
                      "runs": (ends - starts)[owner == k]} for k in range(n)}


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64,
                                   np.uint16])
def test_fill_runs_dense(dtype):
    """numpy_fill_instances: the native run fill for int32 / int64
    buffers, numpy's repeat path for the rest."""
    instances = _fill_instances(np.random.default_rng(15))
    entry = {np.int32: ["fill_runs_i32"], np.int64: ["fill_runs_i64"]}
    got = three_ways(fill.numpy_fill_instances, jax_fill.numpy_fill_instances,
                     lambda: (np.zeros(FILL_SHAPE, dtype), instances),
                     entry.get(dtype, ["fill_runs_i32", "fill_runs_i64"]),
                     declines=dtype not in entry)
    assert got.dtype == np.dtype(dtype)
    assert (got > 0).sum() == sum(int(a["runs"].sum())
                                  for a in instances.values())


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64,
                                   np.uint16])
def test_fill_runs_chunked(dtype):
    """chunked_fill_instances: uint32 / uint64 chunks are filled through
    a signed view of the same width."""
    instances = _fill_instances(np.random.default_rng(16))
    entry = {np.int32: "fill_runs_i32", np.uint32: "fill_runs_i32",
             np.int64: "fill_runs_i64", np.uint64: "fill_runs_i64"}
    got = three_ways(
        lambda store: fill.chunked_fill_instances(
            store, instances, chunks=(4, 8, 16), processes=3),
        lambda store: jax_fill.chunked_fill_instances(
            store, instances, chunks=(4, 8, 16), processes=3),
        lambda: (np.zeros(FILL_SHAPE, dtype),),
        [entry[dtype]] if dtype in entry else list(set(entry.values())),
        declines=dtype not in entry)
    assert_same(got, fill.numpy_fill_instances(np.zeros(FILL_SHAPE, dtype),
                                               instances))


def test_fill_runs_wrapper_contract():
    """Runs are clipped to the buffer; a dtype outside int32 / int64 is
    declined (None, nothing written), as in the JAX package."""
    for dtype in (np.int32, np.int64):
        buf, ref = np.zeros(20, dtype), np.zeros(20, dtype)
        assert native.fill_runs(buf, [-3, 8, 17], [5, 2, 9], 7) is True
        assert jax_native.fill_runs(ref, [-3, 8, 17], [5, 2, 9], 7) is True
        np.testing.assert_array_equal(buf, ref)
        assert np.flatnonzero(buf).tolist() == [0, 1, 8, 9, 17, 18, 19]
    buf = np.zeros(20, np.uint32)
    assert native.fill_runs(buf, [1], [2], 7) is None and not buf.any()
    with pytest.raises(ctypes.ArgumentError):
        native.fill_runs(np.zeros((4, 10), np.int32)[:, ::2], [1], [2], 7)


# --- the library itself -----------------------------------------------------

def test_every_entry_point_is_bound_and_has_a_caller():
    lib = native.get_lib()
    defined = re.findall(r"^(?:int64_t|void) etpu_(\w+)\(",
                         native_build.SOURCE.read_text(), re.M)
    assert sorted(defined) == sorted(native.ENTRY_POINTS)
    assert len(native.ENTRY_POINTS) == 14
    for name in native.ENTRY_POINTS:
        assert getattr(lib, f"etpu_{name}").argtypes, name
    callers = "".join(p.read_text() for p in
                      (ROOT / "empanada_torch").rglob("*.py")
                      if p.name != "native.py")
    for wrapper in WRAPPERS:
        assert callable(getattr(native, wrapper))
        assert f"native.{wrapper}(" in callers, wrapper


def test_builds_from_a_clean_directory_with_gxx_alone(tmp_path):
    """No make, nothing but the compiler: a fresh build directory gets a
    hash-named library whose entry points answer."""
    path = native_build.build(tmp_path / "fresh")
    assert path.parent == tmp_path / "fresh" and path.suffix == ".so"
    assert path.name.startswith("libetpu_core-")
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert native_build.build(tmp_path / "fresh") == path  # found, not rebuilt

    lib = ctypes.CDLL(str(path))
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.etpu_runs_ccl.restype = ctypes.c_int64
    lib.etpu_runs_ccl.argtypes = [p64, p64, p64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int32, p32]
    # two runs on adjacent rows, overlapping columns -> one component
    labels = np.zeros(2, np.int32)
    n = lib.etpu_runs_ccl(np.array([0, 10]), np.array([3, 13]),
                          np.array([1, 1]), 2, 10, 8, labels)
    assert n == 1 and labels[0] == labels[1] == 1


def test_concurrent_first_builds_are_safe(tmp_path):
    """Three processes that all find no library build at once into one
    directory: each ends with a loadable library and no temporary is
    left behind."""
    code = ("import ctypes, sys\n"
            "from empanada_torch import native_build\n"
            "path = native_build.build(sys.argv[1])\n"
            "assert ctypes.CDLL(str(path)).etpu_runs_ccl\n"
            "print(path.name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    names = set()
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        names.add(out.strip())
    assert len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)


@pytest.mark.parametrize("cxx, message", [
    ("/nonexistent/bin/g++", "not found"),
    ("false", "failed"),
])
def test_a_broken_compiler_raises(tmp_path, monkeypatch, cxx, message):
    """No quiet numpy: with no library on disk and a compiler that is
    missing or fails, the build raises, and so does the first call of a
    function of the host half."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=message):
        native_build.build(tmp_path)
    assert list(tmp_path.iterdir()) == []

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=message):
        native.get_lib()
    with pytest.raises(RuntimeError, match=message):
        ranges.ranges_intersection(np.array([[0, 5]]), np.array([[3, 9]]))
    with native.numpy_host_half():  # asked for by name: no compiler needed
        assert ranges.ranges_intersection(np.array([[0, 5]]),
                                          np.array([[3, 9]])) == 2


def test_no_native_environment_variable_gives_the_numpy_path(tmp_path):
    """EMPANADA_TORCH_NO_NATIVE=1, read at first use: every wrapper
    returns None, nothing is built or loaded, the answers are the
    same."""
    code = (
        "import numpy as np\n"
        "from empanada_torch import native_build\n"
        "from empanada_torch.core import ccl, native, ranges\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('built although numpy was asked for')\n"
        "native_build.build = refuse\n"
        "assert native.get_lib() is None\n"
        "assert native.ranges_intersection([[0, 5]], [[3, 9]]) is None\n"
        "assert ranges.ranges_intersection(np.array([[0, 5]]),\n"
        "                                  np.array([[3, 9]])) == 2\n"
        "img = np.array([[1, 1, 0], [0, 1, 0], [2, 0, 1]])\n"
        "out = ccl.connected_components_2d(img)\n"
        "assert out.tolist() == [[1, 1, 0], [0, 1, 0], [2, 0, 1]], out\n"
        "assert native._lib is None and not any(native.CALLS.values())\n"
        "with native.numpy_host_half():\n"
        "    pass\n"
        "assert native.get_lib() is None\n")
    env = dict(os.environ, EMPANADA_TORCH_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_numpy_host_half_restores_the_native_path():
    assert native.get_lib() is not None
    with native.numpy_host_half():
        with native.numpy_host_half():
            assert native.get_lib() is None
        assert native.get_lib() is None
    assert native.get_lib() is not None
    with pytest.raises(KeyError):
        with native.numpy_host_half():
            raise KeyError("x")
    assert native.get_lib() is not None


def test_threads_calling_the_library_at_once_get_the_serial_answers():
    """Three host threads (as three axes' finish threads) call
    pair_intersections and runs_ccl at once; ctypes drops the
    interpreter lock in each call and the library keeps no state, so
    every answer equals the serial one and no count is lost."""
    rng = np.random.default_rng(17)
    jobs = []
    for _ in range(3):
        sa, ra = _instance_set(rng, 40)
        sb, rb = _instance_set(rng, 40)
        rows, cols = (g.ravel() for g in np.meshgrid(
            np.arange(40), np.arange(40), indexing="ij"))
        img = _label_image(rng, (120, 150), 3)
        s, e, v = ccl.image_to_runs(img)
        jobs.append(((sa, ra, sb, rb, rows, cols),
                     (s[v != 0], e[v != 0], v[v != 0], 150, 8)))
    serial = [(rle.rle_pairwise_intersections(*a),
               ccl.runs_connected_components(*b)) for a, b in jobs]

    reps, results, errors = 30, {}, []
    start = threading.Barrier(3)

    def work(k):
        try:
            start.wait(timeout=60)
            out = []
            for _ in range(reps):
                out.append((rle.rle_pairwise_intersections(*jobs[k][0]),
                            ccl.runs_connected_components(*jobs[k][1])))
            results[k] = out
        except Exception as exc:  # reported below, in the main thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    native.reset_calls()
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for k in range(3):
        assert len(results[k]) == reps
        for inter, (labels, n) in results[k]:
            assert_same(inter, serial[k][0])
            assert_same(labels, serial[k][1][0])
            assert n == serial[k][1][1]
    assert native.CALLS["pair_intersections"] == 3 * reps
    assert native.CALLS["runs_ccl"] == 3 * reps
