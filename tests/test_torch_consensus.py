"""Port parity of the cross-axis / cross-tile consensus: the same seeded
trackers and tiles go through the JAX package's inference/consensus.py
and the port's copy, and every output (labels, boxes, starts, runs) must
be exactly equal. Instance ids depend on the order rules of the graph
code, so equality of the dense fills alone would not be enough."""

import numpy as np
import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.inference import consensus as jax_consensus
from empanada_tpu.inference.rle import pan_seg_to_rle_seg as jax_to_rle_seg
from empanada_tpu.inference.tile import Tiler
from empanada_tpu.inference.tracker import InstanceTracker as JaxTracker
from empanada_torch.inference import consensus
from empanada_torch.inference.rle import pan_seg_to_rle_seg
from empanada_torch.inference.tracker import InstanceTracker
from tests.test_consensus_spheres import SHAPE as SPHERE_SHAPE
from tests.test_consensus_spheres import make_spheres
from tests.test_torch_native import with_host_half


def assert_instances_equal(got, want):
    """Same labels in the same order, same boxes, starts and runs."""
    assert list(got) == list(want)
    for label, attrs in want.items():
        assert tuple(int(b) for b in got[label]["box"]) == \
            tuple(int(b) for b in attrs["box"]), label
        np.testing.assert_array_equal(got[label]["starts"], attrs["starts"])
        np.testing.assert_array_equal(got[label]["runs"], attrs["runs"])


def _sphere_volumes():
    """The three label volumes of tests/test_consensus_spheres.py."""
    s2, s4 = make_spheres()
    xy, xz, yz = (np.zeros(SPHERE_SHAPE, np.uint32) for _ in range(3))
    xy[:41, :41, :41][s2 > 0] = 1001
    xy[15:56, 15:56, 15:56][s2 > 0] = 1002
    xz[:41, :41, :41][s2 > 0] = 1005
    xz[15:56, 15:56, 15:56][s4 > 0] = 1004
    xz[:41, 59:100, 59:100][s2 > 0] = 1006
    yz[:41, :41, :41][s2 > 0] = 1003
    yz[15:56, 15:56, 15:56][s4 > 0] = 1003
    return [xy, xz, yz]


def _many_volumes(seed=7, shape=(36, 90, 90), n_objects=120):
    """Three views of ~120 seeded ellipsoids: each view jitters every
    object's center and radii, drops a tenth of the objects and numbers
    them in its own order, as three axis passes would."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    centers = np.stack([rng.uniform(0, d, n_objects),
                        rng.uniform(0, h, n_objects),
                        rng.uniform(0, w, n_objects)], axis=1)
    radii = rng.uniform(2.0, 5.5, (n_objects, 3))
    zz, yy, xx = np.ogrid[:d, :h, :w]
    vols = []
    for _ in range(3):
        vol = np.zeros(shape, np.uint32)
        keep = rng.random(n_objects) > 0.1
        ids = rng.permutation(n_objects) + 1001
        for k in np.flatnonzero(keep):
            c = centers[k] + rng.uniform(-1, 1, 3)
            r = radii[k] * rng.uniform(0.85, 1.15, 3)
            vol[((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                + ((xx - c[2]) / r[2]) ** 2 <= 1] = ids[k]
        vols.append(vol)
    return vols


def _trackers(vols, tracker_cls, to_rle_seg):
    out = []
    for vol in vols:
        tr = tracker_cls(1, 1000, vol.shape, axis="xy")
        for i, sl in enumerate(vol):
            tr.update(to_rle_seg(sl, [1], 1000, [1],
                                 force_connected=False)[1], i)
        tr.finish()
        out.append(tr)
    return out


@pytest.fixture(scope="module")
def tracker_sets():
    """{case: (JAX package's trackers, port's trackers)}; each package
    builds its own from the same volumes."""
    sets = {}
    for case, vols in (("spheres", _sphere_volumes()),
                       ("many", _many_volumes())):
        sets[case] = (_trackers(vols, JaxTracker, jax_to_rle_seg),
                      _trackers(vols, InstanceTracker, pan_seg_to_rle_seg))
    return sets


@pytest.mark.parametrize("case", ["spheres", "many"])
def test_trackers_match(tracker_sets, case):
    want, got = tracker_sets[case]
    n = 0
    for tr_w, tr_g in zip(want, got):
        assert_instances_equal(tr_g.instances, tr_w.instances)
        n += len(tr_g.instances)
    assert n >= (6 if case == "spheres" else 250)


@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("cluster_iou_thr", [0, 0.75])
@pytest.mark.parametrize("pixel_vote_thr", [1, 2, 3])
@pytest.mark.parametrize("case", ["spheres", "many"])
def test_merge_objects_from_trackers(tracker_sets, case, pixel_vote_thr,
                                     cluster_iou_thr, bypass):
    want_trackers, got_trackers = tracker_sets[case]
    want = jax_consensus.merge_objects_from_trackers(
        want_trackers, pixel_vote_thr, cluster_iou_thr, bypass)
    got = consensus.merge_objects_from_trackers(
        got_trackers, pixel_vote_thr, cluster_iou_thr, bypass)
    assert_instances_equal(got, want)
    if case == "many" and pixel_vote_thr < 3:
        assert len(got) > 50


@pytest.mark.parametrize("host_half", ["native", "numpy"])
@pytest.mark.parametrize("cluster_iou_thr", [0, 0.75])
def test_merge_objects_host_halves(tracker_sets, cluster_iou_thr, host_half):
    """The ~330-instance consensus with the host half named: the C++
    core (the default; the graph's batched intersections and the pixel
    vote must have called it) and the numpy paths (asked for; no native
    call). Both equal the JAX package's, RLE for RLE."""
    want_trackers, got_trackers = tracker_sets["many"]
    want = jax_consensus.merge_objects_from_trackers(
        want_trackers, 2, cluster_iou_thr, False)
    got = with_host_half(
        host_half, lambda: consensus.merge_objects_from_trackers(
            got_trackers, 2, cluster_iou_thr, False),
        required=("pair_intersections", "kway_vote"))
    assert_instances_equal(got, want)
    assert len(got) > 50


@pytest.mark.parametrize("pixel_vote_thr", [1, 2, 3])
@pytest.mark.parametrize("case", ["spheres", "many"])
def test_merge_semantic_from_trackers(tracker_sets, case, pixel_vote_thr):
    """Each tracker's instances union-merged to one label (which also
    holds merge_instances' k-way join to the JAX package's), then the
    pixel vote."""
    class _Sem:
        def __init__(self, instances):
            self.instances = instances

    want_trackers, got_trackers = tracker_sets[case]
    want_sem = [_Sem({1001: jax_consensus.merge_instances(tr.instances)})
                for tr in want_trackers]
    got_sem = [_Sem({1001: consensus.merge_instances(tr.instances)})
               for tr in got_trackers]
    for w, g in zip(want_sem, got_sem):
        assert_instances_equal(g.instances, w.instances)
    want = jax_consensus.merge_semantic_from_trackers(want_sem,
                                                      pixel_vote_thr)
    got = consensus.merge_semantic_from_trackers(got_sem, pixel_vote_thr)
    assert_instances_equal(got, want)
    assert len(got) == 1


def _tiles(seed):
    """A seeded field of labeled disks cut into overlapping tiles."""
    rng = np.random.default_rng(seed)
    h = w = 300
    seg = np.zeros((h, w), np.int64)
    yy, xx = np.mgrid[:h, :w]
    for label in range(1, 60):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(5, 16)
        seg[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1000 + label
    tiler = Tiler(seg.shape, tile_size=128, overlap_width=32)
    tiles = []
    for t in range(len(tiler)):
        rle_seg = jax_to_rle_seg(tiler(seg, t), [1], 1000, [1],
                                 force_connected=True)
        tiles.append(tiler.translate_rle_seg(rle_seg, t)[1])
    return tiles, tiler.overlap_rle


@pytest.mark.parametrize("with_overlap", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_objects_from_tiles(seed, with_overlap):
    tiles, overlap_rle = _tiles(seed)
    overlap = overlap_rle if with_overlap else None
    want = jax_consensus.merge_objects_from_tiles(tiles, overlap)
    got = consensus.merge_objects_from_tiles(tiles, overlap)
    assert_instances_equal(got, want)
    assert len(got) > 20


@pytest.mark.parametrize("host_half", ["native", "numpy"])
def test_merge_objects_from_tiles_host_halves(host_half):
    tiles, overlap_rle = _tiles(0)
    want = jax_consensus.merge_objects_from_tiles(tiles, overlap_rle)
    got = with_host_half(
        host_half,
        lambda: consensus.merge_objects_from_tiles(tiles, overlap_rle),
        required=("pair_intersections",))
    assert_instances_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_semantic_from_tiles(seed):
    tiles, _ = _tiles(seed)
    sem_tiles = [{1: consensus.merge_instances(t)} if t else {}
                 for t in tiles]
    want = jax_consensus.merge_semantic_from_tiles(sem_tiles)
    got = consensus.merge_semantic_from_tiles(sem_tiles)
    assert_instances_equal(got, want)
    assert list(got) == [1]
    assert jax_consensus.merge_semantic_from_tiles([{}]) == \
        consensus.merge_semantic_from_tiles([{}]) == {}
