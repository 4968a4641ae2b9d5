"""The bench MitoNet: the port's seeded full-width backbone with
ridge-fitted head classifiers, so that it segments synthetic EM content.

The port's counterpart of the JAX package's ``tools/fit_bench_heads.py``
and of its bench model set-up. Training the 32M-parameter model is out of
a benchmark's budget; a closed-form ridge regression from the frozen
seeded backbone's head features to known synthetic targets is
deterministic and fits in about a minute on a CPU. It fits the four
classifiers only:

- ``semantic_head.Conv_0`` -> +-4 logits of the instance mask;
- ``ins_center.Conv_0`` -> the Gaussian center heatmap;
- ``ins_xy.Conv_0`` -> offsets to the instance centroid (full-resolution
  units);
- the point head's final Dense -> a passthrough of the coarse logit
  channel (the render is then a bilinear refinement, no random flips).

``python -m empanada_torch.bench_heads`` writes ``bench_heads.npz`` beside
this module, in the JAX file's keys and layouts (1x1 conv kernels HWIO,
the Dense kernel (in, out)) plus ``backbone_fingerprint``: the SHA-256
of the backbone it was fitted on. ``splice`` refuses a file whose
fingerprint is not the model's. The backbone comes from one CPU
``torch.Generator`` (``create_model(seed=0)``), so a fit made on a CPU
holds on the card.

Also here: ``content_free`` (the device ceiling without content), the
bench volumes and their inference settings.
"""

from __future__ import annotations

import hashlib
import time
from pathlib import Path

import numpy as np
import torch

from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.models import create_model
from empanada_torch.weights import flax_path

__all__ = ["bench_model", "head_targets", "ridge", "head_features",
           "fit_set", "fit", "main", "splice", "content_free",
           "backbone_fingerprint", "headline_volume", "slab_volume",
           "HEADLINE_SETTINGS", "SLAB_SETTINGS", "NPZ", "NORMS"]

NPZ = Path(__file__).with_name("bench_heads.npz")
NORMS = {"mean": 0.57, "std": 0.12}
BENCH_ARCH = dict(arch="PanopticBiFPNPR", encoder="regnety_6p4gf",
                  num_classes=1)
H = W = 512
FIT_SLICES = 6
# slices a forward when the head features are captured (host memory at
# full width on a CPU)
FEATURE_CHUNK = 2

# the heads whose SeparableConvBNAct_0 output is fitted, their 1x1
# classifier and the npz prefix of its kernel and bias
HEADS = {"semantic_head": "sem", "ins_center": "ctr", "ins_xy": "off"}

# the bench's inference settings: run_inference3d keywords of the
# headline orthoplane volume and of the product-density slab
BENCH_SETTINGS = dict(
    labels=[1], thing_list=[1], mode="orthoplane", qlen=3,
    label_divisor=20000, seg_thr=0.5, nms_thr=0.1, nms_kernel=3,
    iou_thr=0.25, ioa_thr=0.25, pixel_vote_thr=2, cluster_iou_thr=0.75,
    padding_factor=128, block_size=None, norms=NORMS)
HEADLINE_SETTINGS = dict(BENCH_SETTINGS, min_size=200, min_span=2,
                         max_centers=256)
SLAB_SETTINGS = dict(BENCH_SETTINGS, min_size=500, min_span=4,
                     max_centers=512)


def bench_model(device=None, seed=0, dtype="float32"):
    """The port's seeded full-width MitoNet (PanopticBiFPNPR on
    regnety_6p4gf, ``init="random"``) computing in ``dtype`` (its float32
    weights are the same in either) on ``device`` (CUDA unless named;
    raises without a card when none is named)."""
    cfg = dict(BENCH_ARCH)
    return create_model(cfg.pop("arch"), device=device, seed=seed,
                        init="random", dtype=dtype, **cfg)


def headline_volume():
    """The orthoplane headline volume: (128, 320, 320) with 150 disjoint
    ellipsoids (~32 instances a slice in xy). Returns (volume uint8,
    ground truth uint32)."""
    return synthetic_em_volume((128, 320, 320), n_instances=150, seed=11,
                               overlap=False)


def slab_volume():
    """The product-density slab: (128, 512, 512) with 900 disjoint
    ellipsoids (~112 instances a slice in xy, median ~6000 voxels).
    Returns (volume uint8, ground truth uint32)."""
    return synthetic_em_volume((128, 512, 512), n_instances=900, seed=13,
                               overlap=False)


def head_targets(gt_slices, h, w):
    """(sem, ctr, off) targets at 1/4 resolution of (h, w) label slices:
    the instance mask, a Gaussian heatmap of each instance's centroid
    (sigma^2 = 4) and the offsets to it in full-resolution units."""
    n = len(gt_slices)
    h4, w4 = h // 4, w // 4
    sem = np.zeros((n, h4, w4), np.float32)
    ctr = np.zeros((n, h4, w4), np.float32)
    off = np.zeros((n, h4, w4, 2), np.float32)
    yy, xx = np.mgrid[:h4, :w4]
    for b, gt in enumerate(gt_slices):
        gt4 = gt[::4, ::4]
        sem[b] = gt4 > 0
        for v in np.unique(gt4):
            if v == 0:
                continue
            m = gt4 == v
            ys, xs = np.nonzero(m)
            cy, cx = ys.mean(), xs.mean()
            ctr[b] = np.maximum(
                ctr[b], np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0))
            off[b, ..., 0][m] = (cy - yy[m]) * 4
            off[b, ..., 1][m] = (cx - xx[m]) * 4
    return sem, ctr, off


def ridge(X, Y, lam=1e-4):
    """Ridge solution (C, k) of features X (..., C) onto targets Y,
    solved in float64 with a ridge term of lam x the mean diagonal."""
    c = X.shape[-1]
    xm = X.reshape(-1, c).astype(np.float64)
    ym = Y.reshape(xm.shape[0], -1).astype(np.float64)
    xtx = xm.T @ xm
    a = xtx + lam * np.trace(xtx) / c * np.eye(c)
    return np.linalg.solve(a, xm.T @ ym).astype(np.float32)


def head_features(model, batch):
    """{head: (N, h/4, w/4, C) float32} outputs of each head's
    ``SeparableConvBNAct_0`` (forward hooks) for a normalized (N, 1, h, w)
    batch, run ``FEATURE_CHUNK`` slices at a time on the model's
    device."""
    device = next(model.parameters()).device
    feats = {head: [] for head in HEADS}
    hooks = [getattr(model, head).SeparableConvBNAct_0.register_forward_hook(
        lambda _m, _i, out, head=head: feats[head].append(
            out.permute(0, 2, 3, 1).float().cpu().numpy()))
        for head in HEADS]
    try:
        with torch.inference_mode():
            for start in range(0, len(batch), FEATURE_CHUNK):
                x = torch.as_tensor(np.asarray(
                    batch[start:start + FEATURE_CHUNK], np.float32)).to(device)
                model(x)
    finally:
        for hook in hooks:
            hook.remove()
    n_calls = {head: len(f) for head, f in feats.items()}
    if set(n_calls.values()) != {-(-len(batch) // FEATURE_CHUNK)}:
        raise RuntimeError(f"head hooks ran {n_calls} times for "
                           f"{len(batch)} slices in chunks of "
                           f"{FEATURE_CHUNK}")
    return {head: np.concatenate(f) for head, f in feats.items()}


def fit_set():
    """The fit's mixed-density slices of H x W: 6 of a sparse volume (48
    instances, seed 7) and 6 of a product-density one (220, seed 17) at
    ``np.linspace(2, 29, 6)``. Returns (normalized (12, 1, H, W) float32,
    their 12 ground-truth label slices)."""
    vol_s, gt_s = synthetic_em_volume((32, H, W), n_instances=48, seed=7)
    vol_d, gt_d = synthetic_em_volume((32, H, W), n_instances=220, seed=17)
    idx = np.linspace(2, 29, FIT_SLICES).astype(int)
    slices = np.concatenate([vol_s[idx], vol_d[idx]])
    gt_slices = [gt_s[i] for i in idx] + [gt_d[i] for i in idx]
    batch = ((slices.astype(np.float32) / 255.0 - NORMS["mean"])
             / NORMS["std"])[:, None]
    return batch, gt_slices


def _final_dense(keys):
    """State-dict key of the point head's final Dense weight: the last
    ``semantic_pr`` kernel by its flax path (the JAX tool's rule)."""
    dense = sorted((flax_path(k), k) for k in keys
                   if k.startswith("semantic_pr.")
                   and flax_path(k)[-1] == "kernel")
    if not dense:
        raise KeyError("the model has no semantic_pr point head")
    return dense[-1][1]


def _head_keys(keys):
    """The state-dict keys the fitted heads replace."""
    dense = _final_dense(keys)
    out = [f"{head}.Conv_0.{leaf}" for head in HEADS
           for leaf in ("weight", "bias")]
    return out + [dense, dense[: -len("weight")] + "bias"]


def backbone_fingerprint(state):
    """SHA-256 (hex) over the names and float32 bytes of every floating
    tensor of ``state`` (a module or a state_dict) except the fitted
    heads', in name order."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    skip = set(_head_keys(state))
    digest = hashlib.sha256()
    for key in sorted(state):
        t = state[key]
        if key in skip or not t.is_floating_point():
            continue
        digest.update(key.encode())
        digest.update(t.detach().to("cpu", torch.float32).contiguous()
                      .numpy().tobytes())
    return digest.hexdigest()


def fit(model, batch, gt_slices):
    """Ridge-fit the heads of ``model`` on a normalized (N, 1, h, w)
    batch and its label slices. Returns (the npz arrays in the JAX
    layouts, the fit report: semantic IoU overall and on each half of
    the slices, the center heatmap's correlation)."""
    h, w = batch.shape[-2:]
    feats = head_features(model, batch)
    sem_t, ctr_t, off_t = head_targets(gt_slices, h, w)
    w_sem = ridge(feats["semantic_head"], (sem_t * 2 - 1) * 4.0)
    w_ctr = ridge(feats["ins_center"], ctr_t)
    w_off = ridge(feats["ins_xy"], off_t)

    # point-head passthrough: the final Dense's input is [fc features...,
    # coarse logit]; select the coarse channel
    dense = model.state_dict()[_final_dense(model.state_dict())]
    n_cls, in_dim = dense.shape
    w_pr = np.zeros((in_dim, n_cls), np.float32)
    w_pr[-n_cls:] = np.eye(n_cls)

    c = w_sem.shape[0]
    pred = (feats["semantic_head"].reshape(-1, c) @ w_sem).reshape(
        sem_t.shape)
    predc = (feats["ins_center"].reshape(-1, c) @ w_ctr).reshape(
        ctr_t.shape)

    def iou(p, t):
        return float(((p > 0) & (t > 0)).sum()
                     / (((p > 0) | (t > 0)).sum() + 1))

    half = len(gt_slices) // 2
    report = {
        "sem_iou": iou(pred, sem_t),
        "sem_iou_sparse": iou(pred[:half], sem_t[:half]),
        "sem_iou_dense": iou(pred[half:], sem_t[half:]),
        "ctr_corr": float(np.corrcoef(predc.ravel(), ctr_t.ravel())[0, 1]),
    }
    heads = dict(
        sem_kernel=w_sem[None, None], sem_bias=np.zeros(1, np.float32),
        ctr_kernel=w_ctr[None, None], ctr_bias=np.zeros(1, np.float32),
        off_kernel=w_off[None, None], off_bias=np.zeros(2, np.float32),
        pr_kernel=w_pr, pr_bias=np.zeros(n_cls, np.float32),
        norms=np.array([NORMS["mean"], NORMS["std"]], np.float32))
    return heads, report


def splice(model_or_state_dict, npz_path=None):
    """Put the fitted heads of ``npz_path`` (default ``NPZ``) into a bench
    model: a module is changed in place and returned, a state_dict is
    copied. Raises where the file's ``backbone_fingerprint`` is missing
    or is not the model's, or where a shape differs."""
    path = Path(npz_path or NPZ)
    with np.load(path) as data:
        data = dict(data)
    module = model_or_state_dict if hasattr(
        model_or_state_dict, "state_dict") else None
    state = module.state_dict() if module is not None \
        else model_or_state_dict
    if "backbone_fingerprint" not in data:
        raise ValueError(f"{path} carries no backbone_fingerprint: it was "
                         f"not fitted on a backbone of this port")
    have = backbone_fingerprint(state)
    if str(data["backbone_fingerprint"]) != have:
        raise ValueError(f"{path} was fitted on the backbone with "
                         f"fingerprint {data['backbone_fingerprint']}, the "
                         f"model's is {have}; refit with python -m "
                         f"empanada_torch.bench_heads")
    dense = _final_dense(state)
    updates = {dense: data["pr_kernel"].T,
               dense[: -len("weight")] + "bias": data["pr_bias"]}
    for head, tag in HEADS.items():
        # 1x1 conv kernel HWIO -> OIHW
        updates[f"{head}.Conv_0.weight"] = \
            data[f"{tag}_kernel"].transpose(3, 2, 0, 1)
        updates[f"{head}.Conv_0.bias"] = data[f"{tag}_bias"]
    for key, value in updates.items():
        shape = tuple(state[key].shape) if key in state else "missing"
        if shape != value.shape:
            raise ValueError(f"{key}: fitted shape {value.shape}, model "
                             f"{shape}")
    if module is None:
        out = dict(state)
        for key, value in updates.items():
            out[key] = torch.from_numpy(np.array(value, np.float32)).to(
                state[key].device)
        return out
    with torch.no_grad():
        for key, value in updates.items():
            state[key].copy_(torch.from_numpy(np.array(value, np.float32)))
    return module


def content_free(state_dict):
    """The device ceiling without content: every conv and Dense weight of
    ``semantic_head``, ``ins_center`` and ``semantic_pr`` zeroed, and
    their one-channel biases set decisively negative (semantic -2.5,
    center -5.0), so that the outputs are empty background whatever the
    input. Returns a new state_dict."""
    out = dict(state_dict)
    for key, t in state_dict.items():
        if not t.is_floating_point():
            continue
        path = flax_path(key)
        top = path[0]
        if path[-1] == "bias" and t.shape[-1] == 1:
            if "semantic_head" in top or "semantic_pr" in top:
                out[key] = t - 2.5
            elif "ins_center" in top:
                out[key] = t - 5.0
        if path[-1] == "kernel" and ("semantic_head" in top
                                     or "ins_center" in top
                                     or "semantic_pr" in top):
            out[key] = torch.zeros_like(t)
    return out


def main():
    """Fit the heads of ``bench_model(device="cpu")`` and write ``NPZ``."""
    t0 = time.time()
    model = bench_model(device="cpu")
    batch, gt_slices = fit_set()
    heads, report = fit(model, batch, gt_slices)
    print(f"sem fit IoU={report['sem_iou']:.3f}  ctr corr="
          f"{report['ctr_corr']:.3f}")
    for name in ("sparse", "dense"):
        print(f"  {name}: sem IoU={report[f'sem_iou_{name}']:.3f}")
    if not report["sem_iou"] > 0.5:
        raise SystemExit(f"the fit's semantic IoU {report['sem_iou']:.3f} "
                         f"is not above 0.5")
    fingerprint = backbone_fingerprint(model)
    np.savez(NPZ, backbone_fingerprint=np.array(fingerprint), **heads)
    print(f"wrote {NPZ} (backbone {fingerprint}) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
