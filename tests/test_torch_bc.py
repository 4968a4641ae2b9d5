"""Port parity of the boundary-contour family's pipeline: the contour
target (seg_to_instance_bd, without OpenCV) equals the JAX package's
cv2 one; BCDataset's examples; BCLoss; BCEngine / BCEngine3d per slice
(end() included) on a parameter-free BC twin (exact) and a tiny
converted PDL-BC (1e-4 of max); the watershed (numpy copy and the torch
flood on the CPU) label for label; the Tiler; run_bc_inference3d with
the twin exactly; ``python -m empanada_torch evaluate3d_bc`` with
``--device cpu``; and one Trainer epoch on the BC recipe's keys."""

import os

import pytest

# the JAX package's third-party dependencies: where only the port's are
# installed, these parity tests skip
for _dep in ("jax", "flax", "yaml", "cv2"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from empanada_tpu import losses as j_losses
from empanada_tpu.cli.evaluate3d_bc import (
    run_bc_inference3d as j_run_bc_inference3d,
)
from empanada_tpu.data.bc_dataset import BCDataset as JBCDataset
from empanada_tpu.data.utils.target_creation import (
    seg_to_instance_bd as j_seg_to_instance_bd,
)
from empanada_tpu.inference import engines as je
from empanada_tpu.inference import tile as j_tile
from empanada_tpu.inference import watershed as jw
from empanada_tpu.models import create_model as j_create_model
from empanada_torch import losses as t_losses
from empanada_torch.cli import evaluate3d_bc
from empanada_torch.data import create_dataset
from empanada_torch.data.image_files import write_png
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.data.utils.target_creation import seg_to_instance_bd
from empanada_torch.inference import engines as te
from empanada_torch.inference import tile as t_tile
from empanada_torch.inference import watershed as tw
from empanada_torch.models import create_model
from empanada_torch.synthetic import SyntheticBCModule
from empanada_torch.weights import flax_to_torch
from tests.test_torch_models import _randomize
from tests.test_torch_pdl import RNGS, TINY, _close, _nchw


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class JaxSyntheticBCModule:
    """The JAX twin of empanada_torch.synthetic.SyntheticBCModule (NHWC)."""

    num_classes = 1

    def apply(self, variables, images, train=False, render_steps=2,
              interpolate_ins=True, **_):
        m = (images > 0.5).astype(jnp.float32)
        eroded = jax.lax.reduce_window(m, jnp.inf, jax.lax.min,
                                       (1, 3, 3, 1), (1, 1, 1, 1), "SAME")
        up = 2 ** (render_steps - 2)
        out = {}
        for key, mask in (("sem_logits", m), ("cnt_logits", m - eroded)):
            mask = jnp.repeat(jnp.repeat(mask, up, axis=1), up, axis=2)
            out[key] = mask * 16.0 - 8.0
        return out


def _ellipsoids(shape=(12, 40, 36), seed=0, n=3, noise=0.05):
    """Float volume: disjoint-ish ellipsoids at 1 on 0, plus noise; and
    their labels."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    zz, yy, xx = np.mgrid[:d, :h, :w]
    labels = np.zeros(shape, np.uint32)
    centers = [(d / 2, h * (k + 0.5) / n, w / 2) for k in range(n)]
    for k, (cz, cy, cx) in enumerate(centers, 1):
        r = (d / 2.6, h / (2.4 * n), w / 3.0)
        labels[((zz - cz) / r[0]) ** 2 + ((yy - cy) / r[1]) ** 2
               + ((xx - cx) / r[2]) ** 2 <= 1] = k
    vol = (labels > 0).astype(np.float32)
    return vol + rng.normal(0, noise, shape).astype(np.float32), labels


def test_seg_to_instance_bd_matches_cv2():
    rng = np.random.default_rng(0)
    for trial in range(6):
        seg = rng.integers(0, 4, (2, 9, 11)).astype(np.int64)
        if trial % 2:
            seg = np.kron(seg, np.ones((1, 5, 5), np.int64))[:, :37, :41]
        for tsz in (1, 2):
            got = seg_to_instance_bd(seg, tsz)
            want = j_seg_to_instance_bd(seg, tsz_h=tsz)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    _, gt = synthetic_em_volume((3, 64, 64), n_instances=6, seed=1,
                                radius=(4, 12))
    np.testing.assert_array_equal(seg_to_instance_bd(gt),
                                  j_seg_to_instance_bd(gt))


def test_bc_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for sub in ("images", "masks"):
        os.makedirs(tmp_path / "src0" / sub)
    for i in range(2):
        _, gt = synthetic_em_volume((1, 48, 40), n_instances=5, seed=i,
                                    radius=(3, 10))
        write_png(str(tmp_path / "src0" / "images" / f"{i}.png"),
                  rng.integers(0, 255, (48, 40)).astype(np.uint8))
        write_png(str(tmp_path / "src0" / "masks" / f"{i}.png"),
                  gt[0].astype(np.uint16))
    got = create_dataset("BCDataset", str(tmp_path), weight_gamma=0.7)
    want = JBCDataset(str(tmp_path), weight_gamma=0.7)
    np.testing.assert_allclose(got.weights, want.weights)
    for i in range(2):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) == ["cnt", "fname", "image", "sem"]
        for key in ("image", "sem", "cnt"):
            np.testing.assert_array_equal(g[key], w[key])
        assert g["cnt"].sum() > 0


@pytest.mark.parametrize("points", [False, True])
def test_bc_loss_matches_jax(points):
    rng = np.random.default_rng(3)
    n, h, w, p = 2, 16, 20, 12
    out = {"sem_logits": rng.normal(0, 2, (n, h, w, 1)),
           "cnt_logits": rng.normal(0, 2, (n, h, w, 1))}
    target = {"sem": (rng.random((n, h, w)) > 0.5),
              "cnt": (rng.random((n, h, w)) > 0.8)}
    if points:
        for k in ("sem", "cnt"):
            out[f"{k}_points"] = rng.normal(0, 2, (n, p, 1))
            out[f"{k}_point_coords"] = rng.random((n, p, 2))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    target = {k: v.astype(np.float32) for k, v in target.items()}
    kw = dict(pr_weight=0.7, top_k_percent=0.15)
    want_total, want_aux = j_losses.create_loss("BCLoss", **kw)(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in target.items()})
    t_out = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v))
             for k, v in out.items()}
    got_total, got_aux = t_losses.create_loss("BCLoss", **kw)(
        t_out, {k: torch.from_numpy(v) for k, v in target.items()})
    assert sorted(got_aux) == sorted(want_aux)
    for key in want_aux:
        assert float(got_aux[key]) == pytest.approx(float(want_aux[key]),
                                                    rel=1e-5), key
    assert float(got_total) == pytest.approx(float(want_total), rel=1e-5)


def test_bc_engines_match_jax_per_slice():
    """BCEngine and BCEngine3d on the twin: exactly the JAX maps (NCHW
    here, NHWC there), slice by slice and end()."""
    vol, _ = _ellipsoids((7, 36, 30))
    j_model = je.JittedModel(JaxSyntheticBCModule(), {})
    t_model = te.EvalModel(SyntheticBCModule())
    j_2d = je.create_engine("BCEngine", j_model)
    t_2d = te.create_engine("BCEngine", t_model, device="cpu")
    got = t_2d(vol[3])
    assert got.shape == (1, 2, 36, 30)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).numpy(),
        np.asarray(j_2d(vol[3][None, :, :, None])))

    for qlen in (1, 3, 5):
        j_3d = je.create_engine("BCEngine3d", j_model, padding_factor=16,
                                median_kernel_size=qlen)
        t_3d = te.create_engine("BCEngine3d", t_model, padding_factor=16,
                                median_kernel_size=qlen, device="cpu")
        got, want = [], []
        for img in vol:
            w = j_3d(img[None, :, :, None], img.shape)
            g = t_3d(img, img.shape)
            assert (w is None) == (g is None)
            if w is not None:
                want.append(np.asarray(w))
                got.append(g.permute(0, 2, 3, 1).numpy())
        want += [np.asarray(o) for o in j_3d.end()]
        got += [o.permute(0, 2, 3, 1).numpy() for o in t_3d.end()]
        assert len(got) == len(want) == len(vol)
        for z, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (1, 36, 30, 2)
            np.testing.assert_array_equal(g, w, err_msg=f"{qlen} {z}")


def test_bc_engine3d_on_a_converted_pdl_bc():
    """The tiny PDL-BC converted from flax through BCEngine3d: maps
    within 1e-4 of max on every slice (upsampling 1 and 2)."""
    kw = dict(TINY, stage4_stride=16, ins_decoder=True)
    x = np.zeros((1, 64, 64, 1), np.float32)
    j_module = j_create_model("PanopticDeepLabBC", **kw)
    variables = _randomize(j_module.init(RNGS, x, train=False), 3)
    t_module = create_model("PanopticDeepLabBC", device="cpu", **kw)
    t_module.load_state_dict(flax_to_torch(variables, expect=t_module))
    vol = np.random.default_rng(5).normal(0, 1, (4, 50, 60)) \
        .astype(np.float32)
    def j_model(image, render_steps=2):  # eager: no compile per shape
        return j_module.apply(variables, image, train=False,
                              render_steps=render_steps)

    for up in (1, 2):
        size = (50 * up, 60 * up)
        j_3d = je.BCEngine3d(j_model, padding_factor=32)
        t_3d = te.BCEngine3d(te.EvalModel(t_module), padding_factor=32,
                             device="cpu")
        outs = [(j_3d(img[None, :, :, None], size, up), t_3d(img, size, up))
                for img in vol]
        outs += list(zip(j_3d.end(up), t_3d.end(up)))
        outs = [(w, g) for w, g in outs if w is not None]
        assert len(outs) == len(vol)
        for w, g in outs:
            assert tuple(g.shape) == (1, 2) + size
            _close(g, w, f"bc up {up}")


def _bc_stacks(seed):
    """uint8 (2, Z, Y, X) semantic / contour stacks from synthetic
    ground truth: high semantic inside objects, high contour on their
    borders, plus noise."""
    from scipy.ndimage import gaussian_filter

    _, gt = synthetic_em_volume((20, 48, 44), n_instances=10, seed=seed,
                                radius=(3, 9), overlap=seed % 2 == 0)
    fg = gt > 0
    edge = seg_to_instance_bd(gt) > 0
    rng = np.random.default_rng(seed)
    sem = gaussian_filter(fg.astype(float), 1.0) * 255
    cnt = gaussian_filter(edge.astype(float), 0.7) * 400
    stacks = [np.clip(a + rng.normal(0, 10, a.shape), 0, 255)
              .astype(np.uint8) for a in (sem, cnt)]
    return np.stack(stacks)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_mask_wts", [False, True])
def test_bc_watershed_labels_are_exact(seed, use_mask_wts):
    vol = _bc_stacks(seed)
    kw = dict(thres1=0.7, thres2=0.4, thres3=0.3, seed_thres=4,
              min_size=8, label_divisor=1000, use_mask_wts=use_mask_wts)
    want = jw.bc_watershed(vol, **kw)
    stats = {}
    for got in (tw.bc_watershed_numpy(vol, **kw),
                tw.bc_watershed(vol, device="cpu", stats=stats, **kw),
                tw.bc_watershed(torch.from_numpy(vol), device="cpu", **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 4
    assert stats["levels"] == (1 if use_mask_wts else
                               len(np.unique(vol[0][vol[0] > 76])))
    assert stats["rounds"] >= stats["checks"] >= stats["levels"]


def test_mask_and_descending_floods_are_exact():
    vol = _bc_stacks(3)
    rng = np.random.default_rng(4)
    mask = vol[0] > 60
    markers = np.zeros(mask.shape, np.int64)
    idx = rng.choice(np.flatnonzero(mask), 12, replace=False)
    markers.reshape(-1)[idx] = rng.permutation(12) + 1
    want = jw.mask_watershed(mask, markers)
    np.testing.assert_array_equal(tw.mask_watershed(mask, markers), want)
    got = tw.flood_levels(None, torch.from_numpy(markers),
                          torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    want = jw.watershed_descending(vol[0], markers, mask)
    np.testing.assert_array_equal(
        tw.watershed_descending(vol[0], markers, mask), want)
    got = tw.flood_levels(torch.from_numpy(vol[0]),
                          torch.from_numpy(markers), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    for mid in (200, 60000, 2 ** 20):
        assert tw.cast2dtype(np.array([mid])).dtype == \
            jw.cast2dtype(np.array([mid])).dtype


def test_tiler_matches_jax_and_round_trips():
    """Tiles and the overlap RLE equal the JAX package's; tile -> RLE ->
    translate -> merge gives back every disk (F1 1)."""
    from empanada_torch.inference.consensus import merge_objects_from_tiles
    from empanada_torch.inference.matcher import rle_matcher
    from empanada_torch.inference.rle import pan_seg_to_rle_seg

    for length, tile, border in ((300, 128, 32), (1000, 256, 64),
                                 (100, 128, 32), (257, 128, 16)):
        assert t_tile.fixed_size_tiles(length, tile, border) == \
            j_tile.fixed_size_tiles(length, tile, border)
    with pytest.raises(ValueError, match="overlap_width"):
        t_tile.fixed_size_tiles(300, 32, 32)
    h = w = 300
    yy, xx = np.mgrid[:h, :w]
    seg = np.zeros((h, w), np.int64)
    label = 1
    for cy in range(25, h, 50):
        for cx in range(25, w, 50):
            seg[(yy - cy) ** 2 + (xx - cx) ** 2 <= 144] = 1000 + label
            label += 1
    tiler = t_tile.Tiler(seg.shape, tile_size=128, overlap_width=32)
    j_tiler = j_tile.Tiler(seg.shape, tile_size=128, overlap_width=32)
    assert tiler.yranges == j_tiler.yranges and len(tiler) > 4
    for a, b in zip(tiler.overlap_rle, j_tiler.overlap_rle):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tiler.overlap_mask(),
                                  j_tiler.overlap_mask())
    tiles = [tiler.translate_rle_seg(pan_seg_to_rle_seg(
        tiler(seg, t), [1], 1000, [1], force_connected=True), t)[1]
        for t in range(len(tiler))]
    merged = merge_objects_from_tiles(tiles, tiler.overlap_rle)
    gt = pan_seg_to_rle_seg(seg, [1], 1000, [1])[1]
    matched, all_labels, ious = rle_matcher(gt, merged, iou_thr=0.5)
    assert len(matched[0]) == len(all_labels[0]) == len(all_labels[1]) \
        == label - 1
    assert np.all(ious > 0.99)


@pytest.mark.parametrize("mode", ["orthoplane", "stack"])
def test_run_bc_inference3d_with_the_twin_is_exact(mode):
    vol, _ = _ellipsoids()
    kw = dict(mode=mode, qlen=3, padding_factor=16, seg_thr=0.9,
              cnt_thr=0.3, fg_thr=0.5, seed_thres=4, min_size=16,
              label_divisor=1000, progress=False)
    want = j_run_bc_inference3d(je.JittedModel(JaxSyntheticBCModule(), {}),
                                vol, **kw)
    stats = {}
    got = evaluate3d_bc.run_bc_inference3d(SyntheticBCModule(), vol,
                                           device="cpu", stats=stats, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 4  # background and three ellipsoids
    assert stats["watershed"]["levels"] >= 1
    assert set(stats) >= {"xy_seconds", "watershed_seconds"}


def test_evaluate3d_bc_command_on_cpu(tmp_path):
    """A tiny seeded PDL-BC descriptor on a zarr volume: the store equals
    a fill of pred_bc.json, the JSON equals seg_to_tracker of
    run_bc_inference3d, and the ground truth is scored."""
    from empanada_torch.core.fill import numpy_fill_instances
    from empanada_torch.data.zarr_store import create_zarr, open_zarr
    from empanada_torch.evaluation.evaluator import default_evaluator
    from empanada_torch.export import export_model, load_exported_model
    from empanada_torch.inference.tracker import InstanceTracker

    cfg = dict(TINY, arch="PanopticDeepLabBC", stage4_stride=16)
    model = create_model("PanopticDeepLabBC", device="cpu", seed=0,
                         **{k: v for k, v in cfg.items() if k != "arch"})
    export_model(model.state_dict(), cfg, str(tmp_path), "bc",
                 norms={"mean": 0.5, "std": 0.2})
    vol, labels = _ellipsoids((10, 36, 40))
    vol = (np.clip(vol, 0, 1) * 255).astype(np.uint8)
    store = create_zarr(str(tmp_path / "vol.zarr"), vol.shape,
                        dtype=np.uint8)
    store[:, :, :] = vol
    gt_json = str(tmp_path / "gt.json")
    evaluate3d_bc.seg_to_tracker(labels.astype(np.int64) + 1000 * (
        labels > 0)).write_to_json(gt_json)
    flags = ["-seg-thr", "0.5", "-cnt-thr", "0.5", "-fg-thr", "0.3",
             "-seed-thres", "2", "-min-size", "4"]
    results = evaluate3d_bc.main([str(tmp_path / "bc.yaml"),
                                  str(tmp_path / "vol.zarr"), gt_json,
                                  "--device", "cpu", *flags])
    assert results == default_evaluator()(gt_json,
                                          str(tmp_path / "pred_bc.json"))
    tracker = InstanceTracker()
    tracker.load_from_json(str(tmp_path / "pred_bc.json"))
    seg = np.asarray(open_zarr(str(tmp_path / "vol_bc_seg.zarr")))
    dense = np.zeros(vol.shape, np.uint32)
    numpy_fill_instances(dense, tracker.instances)
    np.testing.assert_array_equal(seg, dense)

    model, desc = load_exported_model(str(tmp_path / "bc.yaml"),
                                      device="cpu")
    want = evaluate3d_bc.run_bc_inference3d(
        model, vol, seg_thr=0.5, cnt_thr=0.5, fg_thr=0.3, seed_thres=2,
        min_size=4, norms=desc["norms"], device="cpu", progress=False)
    np.testing.assert_array_equal(seg, want.astype(np.uint32))


def test_bc_recipe_trains_and_validates_on_cpu(tmp_path):
    """One epoch of the BC recipe's keys (BCDataset, BCLoss, PDL-BC,
    validation through BCEngine) on a tiny set: finite losses with the
    JAX package's BC loss keys, and the semantic IoU only."""
    from empanada_torch.train import Trainer
    from tests.test_torch_train_fit import _write_set

    _write_set(str(tmp_path / "train"), [4], size=64)
    _write_set(str(tmp_path / "eval"), [1], size=64, seed=1)
    cfg = {
        "DATASET": {"labels": [1], "thing_list": [1],
                    "class_names": {1: "mito"},
                    "norms": {"mean": 0.5, "std": 0.15}},
        "MODEL": dict(TINY, arch="PanopticDeepLabBC", stage4_stride=16,
                      ins_decoder=True, dtype="bfloat16"),
        "TRAIN": {"batch_size": 2, "train_dir": str(tmp_path / "train"),
                  "model_dir": str(tmp_path / "models"), "workers": 1,
                  "logging": False, "criterion": "BCLoss",
                  "criterion_params": {"pr_weight": 1,
                                       "top_k_percent": 0.15},
                  "dataset_class": "BCDataset",
                  "dataset_params": {"weight_gamma": 0.7},
                  "schedule_params": {"max_lr": 3e-3, "epochs": 1}},
        "EVAL": {"eval_dir": str(tmp_path / "eval"), "epochs_per_eval": 1,
                 "engine": "BCEngine", "engine_params": {},
                 "metrics": [{"metric": "IoU", "name": "semantic_iou",
                              "labels": [1], "output_key": "sem_logits",
                              "target_key": "sem"}]}}
    trainer = Trainer(cfg, device="cpu")
    history = trainer.fit()
    assert set(history[0]) == {"sem_ce", "cnt_ce", "sem_pr_ce", "cnt_pr_ce",
                               "total_loss", "sem_iou"}
    assert all(np.isfinite(v) for v in history[0].values())
    metrics = trainer.validate()
    assert list(metrics) == ["mito_semantic_iou"]
