"""Port parity: ``empanada_torch.bench_heads`` against the JAX package's
``tools/fit_bench_heads.py`` and ``bench.py``.

The same numpy inputs go through the JAX tool's function and the port's:
the fit's targets (exact), the ridge solution (1e-6 relative), the head
features of the tiny MitoNet (regnety_200mf, fpn_layers=1, 128^2; flax
variables converted by ``flax_to_torch``; 1e-5 of max |value|) and the
fitted predictions (1e-4 relative), the spliced and content-free
weights (bit for bit), and, with the JAX fit spliced into both
packages' tiny models, the orthoplane consensus (RLE for RLE).
"""

import pytest

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import numpy as np
import torch
from flax import traverse_util

import bench
from empanada_torch import bench_heads
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.models import create_model
from empanada_torch.weights import flax_to_torch
from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.models import create_model as flax_create_model
from tests.test_torch_consensus import assert_instances_equal
from tests.test_torch_models import TINY, _randomize
from tools import fit_bench_heads as jax_tool

SIDE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU forwards: beside
    other test workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gt_slices(seed, n_instances, shape=(8, 96, 128)):
    _, gt = synthetic_em_volume(shape, n_instances=n_instances, seed=seed)
    return [gt[z] for z in range(0, shape[0], 2)]


@pytest.mark.parametrize("seed, n_instances, shape", [
    (7, 12, (8, 96, 128)),     # sparse, h != w
    (17, 60, (8, 128, 96)),    # dense, w < h
    (3, 0, (4, 64, 64)),       # no instance at all
])
def test_head_targets_equal_the_jax_tool(monkeypatch, seed, n_instances,
                                         shape):
    gt = _gt_slices(seed, n_instances, shape)
    monkeypatch.setattr(jax_tool, "H", shape[1])
    monkeypatch.setattr(jax_tool, "W", shape[2])
    want = jax_tool.head_targets(gt)
    got = bench_heads.head_targets(gt, shape[1], shape[2])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lam, outputs", [(1e-4, 1), (1e-4, 2), (1e-2, 1)])
def test_ridge_equals_the_jax_tool(lam, outputs):
    rng = np.random.default_rng(outputs)
    x = rng.normal(0, 1, (3, 16, 16, 24)).astype(np.float32)
    y = (x[..., :outputs] * 2 + rng.normal(0, 0.1, x.shape[:-1]
                                           + (outputs,))).astype(np.float32)
    want = jax_tool.ridge(x, y, lam=lam)
    got = bench_heads.ridge(x, y, lam=lam)
    assert got.shape == want.shape == (24, outputs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def tiny():
    """The tiny flax MitoNet (seeded random variables of realistic
    scale), the port's model with those weights, and a normalized fit
    batch of 4 disjoint-content slices with its label slices."""
    flax_model = flax_create_model("PanopticBiFPNPR", **TINY)
    # the tree's shapes only (a trace, no init run): _randomize draws
    # every value
    shapes = jax.eval_shape(lambda: flax_model.init(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)},
        np.zeros((1, SIDE, SIDE, 1), np.float32), train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, _randomize(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), shapes), seed=3))
    model = create_model("PanopticBiFPNPR", device="cpu", **TINY)
    model.load_state_dict(flax_to_torch(variables, expect=model))
    vol, gt = synthetic_em_volume((16, SIDE, SIDE), n_instances=40, seed=7,
                                  overlap=False)
    idx = [3, 6, 9, 12]
    batch = ((vol[idx].astype(np.float32) / 255.0 - bench_heads.NORMS["mean"])
             / bench_heads.NORMS["std"])[:, None]
    return flax_model, variables, model, batch, [gt[i] for i in idx]


@pytest.fixture(scope="module")
def jax_fit(tiny):
    """The JAX tool's fit on the tiny model: its captured head features
    (as ``tools/fit_bench_heads.main`` captures them), its targets, its
    ridge solutions, and the npz it would write, in the JAX layout."""
    flax_model, variables, _, batch, gt = tiny
    _, inter = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=False, capture_intermediates=True))(
            variables, batch.transpose(0, 2, 3, 1))
    flat = traverse_util.flatten_dict(inter["intermediates"])
    feats = {head: np.asarray(flat[(head, "SeparableConvBNAct_0",
                                    "__call__")][0])
             for head in bench_heads.HEADS}
    saved = jax_tool.H, jax_tool.W
    jax_tool.H = jax_tool.W = SIDE
    try:
        sem_t, ctr_t, off_t = jax_tool.head_targets(gt)
    finally:
        jax_tool.H, jax_tool.W = saved
    weights = {"sem": jax_tool.ridge(feats["semantic_head"],
                                     (sem_t * 2 - 1) * 4.0),
               "ctr": jax_tool.ridge(feats["ins_center"], ctr_t),
               "off": jax_tool.ridge(feats["ins_xy"], off_t)}
    dense = variables["params"]["semantic_pr"]["StandardPointHead_0"]
    in_dim, n_cls = dense[sorted(k for k in dense
                                 if k.startswith("Dense"))[-1]]["kernel"].shape
    w_pr = np.zeros((in_dim, n_cls), np.float32)
    w_pr[-n_cls:] = np.eye(n_cls)
    heads = {f"{tag}_kernel": w[None, None] for tag, w in weights.items()}
    heads.update(sem_bias=np.zeros(1, np.float32),
                 ctr_bias=np.zeros(1, np.float32),
                 off_bias=np.zeros(2, np.float32),
                 pr_kernel=w_pr, pr_bias=np.zeros(n_cls, np.float32),
                 norms=np.array([0.57, 0.12], np.float32))
    return feats, weights, heads


def _write_npz(path, heads, model):
    np.savez(path, backbone_fingerprint=np.array(
        bench_heads.backbone_fingerprint(model)), **heads)
    return str(path)


def test_head_features_equal_the_jax_capture(tiny, jax_fit):
    _, _, model, batch, _ = tiny
    got = bench_heads.head_features(model, batch)
    for head, want in jax_fit[0].items():
        assert got[head].shape == want.shape == (4, SIDE // 4, SIDE // 4,
                                                 want.shape[-1])
        scale = np.abs(want).max()
        assert np.abs(got[head] - want).max() <= 1e-5 * scale, head


def test_fitted_predictions_agree_with_the_jax_fit(tiny, jax_fit):
    """The port's fit on its own features predicts what the JAX tool's
    fit predicts on its features (1e-4 of max |value|); its report is
    the JAX tool's."""
    _, _, model, batch, gt = tiny
    feats, weights, _ = jax_fit
    heads, report = bench_heads.fit(model, batch, gt)
    got_feats = bench_heads.head_features(model, batch)
    for head, tag in bench_heads.HEADS.items():
        c = feats[head].shape[-1]
        want = feats[head].reshape(-1, c) @ weights[tag]
        got = got_feats[head].reshape(-1, c) @ heads[f"{tag}_kernel"][0, 0]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), head
    pred = feats["semantic_head"].reshape(
        -1, feats["semantic_head"].shape[-1]) @ weights["sem"]
    target = bench_heads.head_targets(gt, SIDE, SIDE)[0].reshape(-1)
    iou = ((pred[:, 0] > 0) & (target > 0)).sum() \
        / (((pred[:, 0] > 0) | (target > 0)).sum() + 1)
    assert abs(report["sem_iou"] - iou) <= 1e-3
    np.testing.assert_array_equal(heads["pr_kernel"],
                                  jax_fit[2]["pr_kernel"])


def test_splice_equals_the_jax_splice(tmp_path, tiny, jax_fit):
    """splice on the converted tiny model == flax_to_torch of the JAX
    package's splice_bench_heads, bit for bit, PointRend Dense included;
    on a state_dict and on a module alike."""
    _, variables, model, _, _ = tiny
    path = _write_npz(tmp_path / "heads.npz", jax_fit[2], model)
    want = flax_to_torch(jax_tool.splice_bench_heads(variables, path))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    got = bench_heads.splice(state, path)
    module = create_model("PanopticBiFPNPR", device="cpu", **TINY)
    module.load_state_dict(state)
    assert bench_heads.splice(module, path) is module
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(module.state_dict()[key], want[key]), key
    assert torch.equal(state["ins_xy.Conv_0.weight"],
                       model.state_dict()["ins_xy.Conv_0.weight"])
    final = "semantic_pr.StandardPointHead_0.Dense_3"
    assert not torch.equal(got[f"{final}.weight"],
                           state[f"{final}.weight"])


def test_content_free_equals_the_jax_bench(tiny):
    _, variables, model, _, _ = tiny
    want = flax_to_torch(bench.content_free_variables(None, variables))
    got = bench_heads.content_free(model.state_dict())
    assert set(got) == set(want)
    changed = 0
    for key in want:
        assert torch.equal(got[key], want[key]), key
        changed += not torch.equal(got[key], model.state_dict()[key])
    assert changed >= 8


@pytest.mark.parametrize("fault", ["fingerprint", "no-fingerprint", "shape"])
def test_splice_refuses(tmp_path, tiny, jax_fit, fault):
    _, _, model, _, _ = tiny
    heads = dict(jax_fit[2])
    fingerprint = bench_heads.backbone_fingerprint(model)
    if fault == "shape":
        heads["off_kernel"] = heads["off_kernel"][..., :1]
    path = tmp_path / "heads.npz"
    if fault == "no-fingerprint":
        np.savez(path, **heads)
    else:
        other = {k: v.clone() for k, v in model.state_dict().items()}
        other["ins_xy.SeparableConvBNAct_0.Conv_1.weight"][0, 0] += 1e-6
        np.savez(path, backbone_fingerprint=np.array(
            bench_heads.backbone_fingerprint(
                other if fault == "fingerprint" else model)), **heads)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="fingerprint|shape"):
        bench_heads.splice(model, path)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    # the heads take no part in the fingerprint
    assert bench_heads.backbone_fingerprint(model) == fingerprint


def test_committed_heads_fit_the_full_width_backbone():
    """The committed bench_heads.npz was fitted on the port's seeded
    full-width MitoNet: its fingerprint is bench_model's, its arrays
    have the JAX file's keys and layouts, and it splices."""
    model = bench_heads.bench_model(device="cpu")
    with np.load(bench_heads.NPZ) as data:
        data = dict(data)
    with np.load(jax_tool.OUT) as jax_file:
        assert set(jax_file) | {"backbone_fingerprint"} == set(data)
        for key in jax_file:
            assert data[key].shape == jax_file[key].shape, key
    assert str(data["backbone_fingerprint"]) == \
        bench_heads.backbone_fingerprint(model)
    np.testing.assert_array_equal(data["norms"],
                                  np.array([0.57, 0.12], np.float32))
    bench_heads.splice(model)
    assert torch.equal(model.ins_xy.Conv_0.weight[..., 0, 0],
                       torch.from_numpy(data["off_kernel"][0, 0].T))


def test_orthoplane_with_the_jax_fit_equals_jax(tmp_path, tiny, jax_fit):
    """With the JAX fit spliced into both packages' tiny models,
    run_inference3d(orthoplane) on a small disjoint volume gives the same
    consensus RLEs, with at least two instances."""
    flax_model, variables, model, _, _ = tiny
    path = _write_npz(tmp_path / "heads.npz", jax_fit[2], model)
    jax_variables = jax_tool.splice_bench_heads(variables, path)
    bench_heads.splice(model, path)
    vol, _ = synthetic_em_volume((32, 32, 32), n_instances=8, seed=5,
                                 overlap=False)
    kwargs = dict(labels=[1], thing_list=[1], mode="orthoplane",
                  norms=bench_heads.NORMS, seg_thr=0.5, min_size=20,
                  min_span=2, max_centers=64,
                  progress=False)
    want = jax_run_inference3d((flax_model, jax_variables), vol, **kwargs)
    got = run_inference3d(model, vol, device="cpu", **kwargs)
    assert len(want[1].instances) >= 2
    assert_instances_equal(got[1].instances, want[1].instances)
