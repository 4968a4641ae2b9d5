"""Fit the inference cells' head classifiers on the plain reference:

    python3 -m portbench.fit_heads [--device cuda] [--out <file.npz>]

The inference cells segment with the bench MitoNet: the seeded backbone
of ``weights.bench_backbone`` and four classifiers fitted to synthetic
EM content by a closed-form ridge regression, so that it segments
without training. The fit runs the plain reference
(``reference.models.MitoNet``, float32, TF32 off) on twelve seeded
slices of 512^2 (six of a sparse volume of 48 ellipsoids, seed 7, and
six of a dense one of 220, seed 17), takes each head's
``SeparableConvBNAct_0`` output and regresses it onto targets made from
the ground truth at 1/4 resolution:

- ``semantic_head.Conv_0`` -> +-4 logits of the instance mask;
- ``ins_center.Conv_0`` -> a Gaussian heatmap of each centroid;
- ``ins_xy.Conv_0`` -> offsets to the centroid, in full-resolution
  units;
- the point head's last Dense -> a passthrough of the coarse logit.

It writes ``configs/mitonet_bench_heads.npz`` (1x1 kernels HWIO, the
Dense kernel (in, out), biases zero) with the SHA-256 of the backbone
(``weights.fingerprint``); ``weights.bench_state`` refuses a file fitted
on another backbone. The committed file was written by this tool on the
card; nothing of the measured program goes into it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import gen
from portbench.reference import models as ref_models
from portbench.spec import HERE
from portbench.weights import (BENCH_HEADS, bench_backbone, fingerprint,
                               head_keys)

__all__ = ["fit_set", "head_targets", "ridge", "features", "fit", "main"]

OUT = HERE / "configs" / "mitonet_bench_heads.npz"
SIZE = 512
FIT_SLICES = 6
CHUNK = 2
# (instances, seed) of the fit's sparse and dense volumes
VOLUMES = ((48, 7), (220, 17))
# the inference cells' normalization (their traffic's ``norms``)
NORMS = (0.57, 0.12)


def fit_set(size=SIZE, norms=NORMS):
    """(normalized (12, 1, size, size) float32 slices, their label
    slices): ``FIT_SLICES`` slices at ``linspace(2, 29)`` of each of
    ``VOLUMES`` (32 slices deep, overlapping ellipsoids)."""
    idx = np.linspace(2, 29, FIT_SLICES).astype(int)
    slices, labels = [], []
    for n, seed in VOLUMES:
        vol, gt = gen.em_volume({"shape": [32, size, size], "instances": n,
                                 "overlap": True}, seed)
        slices.append(vol[idx])
        labels.extend(gt[i] for i in idx)
    x = (np.concatenate(slices).astype(np.float32) / 255.0 - norms[0]) \
        / norms[1]
    return x[:, None], labels


def head_targets(labels, h, w):
    """(sem, ctr, off) at 1/4 of (h, w): the instance mask, the maximum
    of a Gaussian (sigma^2 4) at each instance's centroid, and the
    offsets (dy, dx) to it times 4."""
    n, h4, w4 = len(labels), h // 4, w // 4
    sem = np.zeros((n, h4, w4), np.float32)
    ctr = np.zeros((n, h4, w4), np.float32)
    off = np.zeros((n, h4, w4, 2), np.float32)
    yy, xx = np.mgrid[:h4, :w4]
    for b, lab in enumerate(labels):
        lab4 = lab[::4, ::4]
        sem[b] = lab4 > 0
        for v in np.unique(lab4):
            if v == 0:
                continue
            m = lab4 == v
            ys, xs = np.nonzero(m)
            cy, cx = ys.mean(), xs.mean()
            ctr[b] = np.maximum(
                ctr[b], np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0))
            off[b, ..., 0][m] = (cy - yy[m]) * 4
            off[b, ..., 1][m] = (cx - xx[m]) * 4
    return sem, ctr, off


def ridge(x, y, lam=1e-4):
    """(C, k) ridge solution of features (..., C) onto targets, in
    float64, with a ridge term of ``lam`` times the mean diagonal."""
    c = x.shape[-1]
    xm = x.reshape(-1, c).astype(np.float64)
    ym = y.reshape(xm.shape[0], -1).astype(np.float64)
    xtx = xm.T @ xm
    a = xtx + lam * np.trace(xtx) / c * np.eye(c)
    return np.linalg.solve(a, xm.T @ ym).astype(np.float32)


def features(model, x, device, chunk=CHUNK):
    """{head: (N, h/4, w/4, C) float32} of each head's
    ``SeparableConvBNAct_0`` on the normalized batch ``x``."""
    out = {head: [] for head in BENCH_HEADS}
    with torch.no_grad():
        for i in range(0, len(x), chunk):
            feats = model.features(torch.from_numpy(x[i:i + chunk])
                                   .to(device))
            for head in BENCH_HEADS:
                y = getattr(model, head).SeparableConvBNAct_0(feats)
                out[head].append(y.permute(0, 2, 3, 1).float().cpu()
                                 .numpy())
    return {head: np.concatenate(v) for head, v in out.items()}


def fit(cfg, device, size=SIZE):
    """(the npz arrays, a report) for configuration ``cfg`` on
    ``device``."""
    num_fc = cfg["recipe"]["MODEL"]["num_fc"]
    classes = cfg["recipe"]["MODEL"]["num_classes"]
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = ref_models.build(cfg, device)
        shapes = {k: (tuple(v.shape), v.dtype)
                  for k, v in model.state_dict().items()}
        state = bench_backbone(shapes)
        model.load_state_dict(state)
        model.eval()
        x, labels = fit_set(size)
        feats = features(model, x, device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    sem_t, ctr_t, off_t = head_targets(labels, size, size)
    w_sem = ridge(feats["semantic_head"], (sem_t * 2 - 1) * 4.0)
    w_ctr = ridge(feats["ins_center"], ctr_t)
    w_off = ridge(feats["ins_xy"], off_t)
    dim = cfg["recipe"]["MODEL"]["fpn_dim"]
    w_pr = np.zeros((dim + classes, classes), np.float32)
    w_pr[-classes:] = np.eye(classes)

    c = w_sem.shape[0]
    sem = (feats["semantic_head"].reshape(-1, c) @ w_sem).reshape(sem_t.shape)
    ctr = (feats["ins_center"].reshape(-1, c) @ w_ctr).reshape(ctr_t.shape)

    def iou(p, t):
        return float(((p > 0) & (t > 0)).sum()
                     / (((p > 0) | (t > 0)).sum() + 1))

    half = len(labels) // 2
    report = {"sem_iou": iou(sem, sem_t),
              "sem_iou_sparse": iou(sem[:half], sem_t[:half]),
              "sem_iou_dense": iou(sem[half:], sem_t[half:]),
              "ctr_corr": float(np.corrcoef(ctr.ravel(), ctr_t.ravel())[0, 1])}
    heads = dict(
        sem_kernel=w_sem[None, None], sem_bias=np.zeros(classes, np.float32),
        ctr_kernel=w_ctr[None, None], ctr_bias=np.zeros(1, np.float32),
        off_kernel=w_off[None, None], off_bias=np.zeros(2, np.float32),
        pr_kernel=w_pr, pr_bias=np.zeros(classes, np.float32),
        norms=np.array(NORMS, np.float32),
        backbone_fingerprint=np.array(fingerprint(state,
                                                  head_keys(num_fc))))
    return heads, report


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.fit_heads")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    cfg = json.loads((HERE / "configs" / "mitonet.json").read_text())
    t0 = time.perf_counter()
    heads, report = fit(cfg, torch.device(args.device))
    np.savez(args.out, **heads)
    print(json.dumps(dict(report, out=args.out,
                          seconds=time.perf_counter() - t0)))
    if not report["sem_iou"] > 0.5:
        print(f"the fit's semantic IoU {report['sem_iou']:.3f} is not "
              f"above 0.5", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
