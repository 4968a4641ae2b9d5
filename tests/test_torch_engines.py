"""Port parity of the train-time metrics and the 2D engines: IoU / PQ /
F1 on seeded maps within 1e-12 of the JAX package's, the meters and
ComposeMetrics; PanopticDeepLabEngine and PanopticDeepLabRenderEngine
give the JAX package's panoptic ids exactly, on the parameter-free
synthetic model and on the tiny MitoNet (converted weights); the
engines refuse what is not ported and raise without a card."""

import pytest

for _dep in ("jax", "flax"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from empanada_tpu import metrics as jm
from empanada_tpu.inference import engines as je
from empanada_tpu.models import create_model as j_create_model
from empanada_torch import metrics as tm
from empanada_torch.inference import engines as te
from empanada_torch.models import create_model
from empanada_torch.ops import group
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.weights import flax_to_torch
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_models import _randomize



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module: the suite runs six pytest
    workers on the machine's cores, and torch's default (one thread a
    core in every worker) makes their spinning threads starve each
    other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

def _pan_maps(seed, h=48, w=40, label_divisor=1000):
    """Seeded panoptic maps: class 1 and 2 instances of random boxes."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.int64)
    for k in range(12):
        cls = 1 + k % 2
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
        dy, dx = rng.integers(3, 14, 2)
        out[y:y + dy, x:x + dx] = cls * label_divisor + 1 + k // 2
    return out


@pytest.mark.parametrize("c", [1, 3])
def test_iou_matches_jax(c):
    rng = np.random.default_rng(c)
    logits = rng.normal(0, 1, (1, 30, 26, c)).astype(np.float32)
    tgt = rng.integers(0, max(c, 2), (1, 30, 26))
    labels = list(range(c)) if c > 1 else [1]
    want = jm.IoU(jm.EMAMeter, labels).calculate(
        {"sem_logits": jnp.asarray(logits)}, {"sem": jnp.asarray(tgt)})
    got = tm.IoU(tm.EMAMeter, labels).calculate(
        {"sem_logits": torch.from_numpy(logits).permute(0, 3, 1, 2)},
        {"sem": torch.from_numpy(tgt)})
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name, kwargs", [
    ("PQ", {}), ("F1", {"iou_thr": 0.5}), ("F1", {"iou_thr": 0.75})])
def test_pq_and_f1_match_jax(seed, name, kwargs):
    pred, tgt = _pan_maps(seed), _pan_maps(seed + 10)
    pred[_pan_maps(seed + 20) > 0] = 0  # partial overlaps
    want = getattr(jm, name)(jm.EMAMeter, [1, 2], 1000, **kwargs).calculate(
        {"pan_seg": pred[None]}, {"pan_seg": tgt[None]})
    got = getattr(tm, name)(tm.EMAMeter, [1, 2], 1000, **kwargs).calculate(
        {"pan_seg": torch.from_numpy(pred[None])}, {"pan_seg": tgt[None]})
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_meters_and_compose_metrics_stream_like_jax(capsys):
    specs = [("IoU", {"labels": [1]}),
             ("PQ", {"labels": [1], "label_divisor": 1000}),
             ("F1", {"labels": [1], "label_divisor": 1000, "iou_thr": 0.5})]
    bundles = []
    for mod, meter in ((jm, "EMAMeter"), (tm, "AverageMeter"),
                       (jm, "AverageMeter"), (tm, "EMAMeter")):
        bundles.append((mod, mod.ComposeMetrics(
            {f"m{i}": mod.create_metric(n, meter, **p)
             for i, (n, p) in enumerate(specs)}, {1: "mito"})))
    rng = np.random.default_rng(3)
    for step in range(4):
        logits = rng.normal(0, 1, (1, 48, 40, 1)).astype(np.float32)
        sem = rng.integers(0, 2, (1, 48, 40))
        pan_p, pan_t = _pan_maps(step) % 2000, _pan_maps(step + 5) % 2000
        for mod, bundle in bundles:
            if mod is jm:
                bundle.evaluate({"sem_logits": jnp.asarray(logits),
                                 "pan_seg": pan_p[None]},
                                {"sem": jnp.asarray(sem),
                                 "pan_seg": pan_t[None]})
            else:
                bundle.evaluate(
                    {"sem_logits": torch.from_numpy(logits).permute(0, 3, 1,
                                                                    2),
                     "pan_seg": pan_p[None]},
                    {"sem": torch.from_numpy(sem), "pan_seg": pan_t[None]})
    for (_, a), (_, b) in ((bundles[0], bundles[3]),
                           (bundles[2], bundles[1])):
        for name in a.metrics_dict:
            for label, v in a.metrics_dict[name].average().items():
                assert abs(b.metrics_dict[name].average()[label] - v) \
                    <= 1e-12
    bundles[3][1].display()
    assert "mito_m1" in capsys.readouterr().out
    assert bundles[3][1].history["mito_m0"]
    with pytest.raises(ValueError, match="unknown metric"):
        tm.create_metric("Nope", "EMAMeter", labels=[1])


class _FullRes:
    """Wraps a synthetic module so that interpolate_ins=True gives the
    center heatmap and offsets at full resolution (nearest x4), the
    non-render engine's contract."""

    def __init__(self, module, jax_side):
        self.module = module
        self.jax_side = jax_side

    def apply(self, variables, images, train=False, render_steps=2,
              interpolate_ins=True):
        out = dict(self.module.apply(variables, images, train, render_steps))
        if interpolate_ins:
            for k in ("ctr_hmp", "offsets"):
                out[k] = jnp.repeat(jnp.repeat(out[k], 4, 1), 4, 2)
        return out


class _TorchFullRes(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.module = SyntheticModule()

    def forward(self, images, render_steps=2, interpolate_ins=True):
        out = dict(self.module(images, render_steps))
        if interpolate_ins:
            for k in ("ctr_hmp", "offsets"):
                out[k] = out[k].repeat_interleave(4, 2).repeat_interleave(4,
                                                                          3)
        return out


def _blob_image(seed, h=96, w=112):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w), np.float32)
    cy, cx = rng.uniform(30, h - 30), rng.uniform(30, w - 30)
    img[(yy - cy) ** 2 / 300 + (xx - cx) ** 2 / 150 <= 1] = 1.0
    img[(yy - cy - 10) ** 2 / 30 + (xx - cx + 12) ** 2 / 60 <= 1] = 1.0
    return img


ENGINE_KW = dict(thing_list=[1], label_divisor=1000, stuff_area=16,
                 nms_threshold=0.1, nms_kernel=7, max_centers=32)


@pytest.mark.parametrize("seed", [0, 1])
def test_engines_on_the_synthetic_model_give_jax_ids(seed):
    img = _blob_image(seed)
    j_model = je.JittedModel(_FullRes(JaxSyntheticModule(), True), {})
    t_model = te.EvalModel(_TorchFullRes())
    want = np.asarray(je.PanopticDeepLabEngine(j_model, **ENGINE_KW)(img))
    got = te.PanopticDeepLabEngine(t_model, device="cpu", **ENGINE_KW)(img)
    assert want.max() > 1000
    np.testing.assert_array_equal(got.numpy(), want)

    j_model = je.JittedModel(JaxSyntheticModule(), {})
    t_model = te.EvalModel(SyntheticModule())
    for up in (1, 2):
        size = (img.shape[0] * up, img.shape[1] * up)
        want = np.asarray(je.PanopticDeepLabRenderEngine(
            j_model, padding_factor=32, **ENGINE_KW)(img, size, up))
        got = te.PanopticDeepLabRenderEngine(
            t_model, padding_factor=32, device="cpu", **ENGINE_KW)(
            img, size, up)
        assert want.max() > 1000
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def tiny_pair():
    kw = dict(encoder="regnety_200mf", fpn_layers=1, num_classes=1,
              subdivision_num_points=256)
    flax_model = j_create_model("PanopticBiFPNPR", **kw)
    init = jax.jit(lambda r, x: flax_model.init(r, x, train=False))(
        {"params": jax.random.key(0), "points": jax.random.key(1)},
        np.zeros((1, 128, 128, 1), np.float32))
    variables = _randomize(init, seed=3)
    torch_model = create_model("PanopticBiFPNPR", device="cpu", **kw)
    torch_model.load_state_dict(flax_to_torch(variables, expect=torch_model))
    return je.JittedModel(flax_model, variables), te.EvalModel(torch_model)


@pytest.mark.parametrize("engine", ["PanopticDeepLabEngine",
                                    "PanopticDeepLabRenderEngine"])
def test_engines_on_the_tiny_mitonet_give_jax_ids(tiny_pair, engine):
    j_model, t_model = tiny_pair
    rng = np.random.default_rng(9)
    img = rng.normal(0, 1, (128, 128)).astype(np.float32)
    # the seeded weights give center heatmaps below 0.04: a low NMS
    # threshold makes instances
    kw = dict(ENGINE_KW, confidence_thr=0.5, stuff_area=4,
              nms_threshold=0.01)
    j_engine = je.create_engine(engine, j_model, **kw)
    t_engine = te.create_engine(engine, t_model, device="cpu", **kw)
    launches = group.LAUNCHES["group_pixels"]
    if engine == "PanopticDeepLabEngine":
        want, got = j_engine(img[None, :, :, None]), t_engine(img)
    else:
        want = j_engine(img[None, :, :, None], img.shape)
        got = t_engine(img, img.shape)
    assert group.LAUNCHES["group_pixels"] == launches  # CPU: plain version
    want = np.asarray(want)
    assert len(np.unique(want)) > 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_unported_engines_and_device_rules(monkeypatch):
    for name in ("PanopticDeepLabEngine3d", "PanopticDeepLabRenderEngine3d",
                 "BCEngine", "BCEngine3d"):
        with pytest.raises(NotImplementedError, match=name):
            te.create_engine(name, None, thing_list=[1], device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        te.create_engine("Nope", None, thing_list=[1], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        te.create_engine("PanopticDeepLabEngine", None, thing_list=[1])
