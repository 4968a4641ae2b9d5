"""Plain reference of 3D inference, stack and orthoplane, on dense arrays:
the model in float32 (``models.MitoNet.infer``) slice by slice, then
NumPy and SciPy on label images and label volumes.

Per axis (a stack runs the xy axis alone):

1. each slice normalized, zero-padded to a multiple of ``padding``, and
   run through the model: the foreground probability (sigmoid) at full
   resolution, the center heatmap and the offsets at 1/4;
2. the probability of slice z is the median of slices z - 1 .. z + 1
   (``qlen`` slices; a slice nearer the ends keeps its own);
3. centers: heatmap values above ``nms_thr`` that are the maximum of
   their ``nms_kernel`` square, the ``max_centers`` highest; each 1/4
   cell joins the center nearest to its position plus its offset
   (positions at full resolution); a pixel whose probability is at
   least ``seg_thr`` takes its cell's center; each center's pixels
   split into 8-connected components, the slice's 2D instances;
4. forward through the slices, each instance takes the label of the
   previous slice's instance it matches (the assignment of largest total
   IoU, pairs of IoU at least ``iou_thr``), or else that of the previous
   instance that covers the largest share of it where that share is at
   least ``ioa_thr``, or else a new label; then backward from the last
   slice the same way, keeping its own label where nothing matches;
5. a 3D instance is a label's voxels; those under ``min_size`` voxels or
   spanning fewer than ``min_span`` slices along any axis are dropped.

Orthoplane then takes the consensus of the three axes' instances:
instances of different axes that overlap form a graph; within each
connected group, instances joined by IoU above ``cluster_iou_thr`` form
clusters, linked clusters are merged (the best connected first: it
takes its neighbours, or joins each of them where a neighbour is
larger), each cluster of at least two instances keeps the voxels that
at least ``pixel_vote_thr`` of its instances cover, and such results
that overlap (IoU above 0.01 or over 100 voxels) are merged; the size
and span filters run again. The answer is the label volume with the
instances painted in order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

__all__ = ["axis_instances", "segment", "compare_labels", "MIN_IOU",
           "MIN_OVERLAP"]

MIN_IOU = 1e-2
MIN_OVERLAP = 100
EIGHT = np.ones((3, 3), bool)


# --- device half ----------------------------------------------------------

def _maps(model, slices, s, device, batch):
    """(n, H, W) uint8 slices -> foreground probability (n, PH, PW) and
    heatmap (n, ph, pw), offsets (n, ph, pw, 2) on the padded grid."""
    n, h, w = slices.shape
    f = s["padding"]
    ph, pw = -(-h // f) * f, -(-w // f) * f
    probs, ctrs, offs = [], [], []
    with torch.no_grad():
        for i in range(0, n, batch):
            x = torch.from_numpy(np.ascontiguousarray(slices[i:i + batch]))
            x = x.to(device).float()[:, None]
            x = (x / 255.0 - s["norms"]["mean"]) / s["norms"]["std"]
            x = F.pad(x, (0, pw - w, 0, ph - h))
            logits, ctr, off = model.infer(x)
            probs.append(torch.sigmoid(logits[:, 0]))
            ctrs.append(ctr[:, 0])
            offs.append(off.permute(0, 2, 3, 1))
    return torch.cat(probs), torch.cat(ctrs), torch.cat(offs)


def _median_z(prob, k):
    mid = k // 2
    out = prob.clone()
    n = prob.shape[0]
    if n >= k:
        win = prob.unfold(0, k, 1)
        out[mid:n - mid] = win.median(dim=-1).values
    return out


def _centers(ctr, s):
    """(B, h, w) heatmaps -> per slice (K, 2) centers (y, x)."""
    k = s["nms_kernel"]
    x = torch.where(ctr > s["nms_thr"], ctr, torch.full_like(ctr, -1.0))
    pooled = F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]
    score = torch.where((x == pooled) & (x > 0), x,
                        torch.full_like(x, -float("inf")))
    b, h, w = ctr.shape
    flat = score.reshape(b, -1)
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices
    order = order[:, :s["max_centers"]]
    out = []
    for i in range(b):
        idx = order[i][flat[i, order[i]] > 0]
        out.append(torch.stack([idx // w, idx % w], -1))
    return out


def _group(centers, off):
    """(K, 2) centers, (h, w, 2) offsets -> (h, w) ids 1..K of the
    nearest center to each cell's position plus offset (0 without
    centers)."""
    h, w, _ = off.shape
    if len(centers) == 0:
        return torch.zeros((h, w), dtype=torch.long, device=off.device)
    yy = torch.arange(h, device=off.device).float()[:, None] * 4
    xx = torch.arange(w, device=off.device).float()[None, :] * 4
    py = (yy + off[..., 0]).reshape(-1, 1)
    px = (xx + off[..., 1]).reshape(-1, 1)
    c = centers.float() * 4
    best = None
    for k0 in range(0, len(c), 128):
        d = (py - c[None, k0:k0 + 128, 0]) ** 2 \
            + (px - c[None, k0:k0 + 128, 1]) ** 2
        val, idx = d.min(dim=1)
        if best is None:
            best, arg = val, idx
        else:
            take = val < best
            best = torch.where(take, val, best)
            arg = torch.where(take, idx + k0, arg)
    return (arg + 1).reshape(h, w)


def _slice_labels(prob, ctr, off, s, crop):
    """(B, PH, PW) probabilities, heatmaps, offsets -> (B, H, W) int32
    2D instance labels (8-connected components of each center's
    foreground pixels, numbered from 1 in each slice)."""
    centers = _centers(ctr, s)
    oh, ow = crop
    out = np.zeros((len(centers), oh, ow), np.int32)
    for i, c in enumerate(centers):
        ids = _group(c, off[i])
        ids = ids.repeat_interleave(4, 0).repeat_interleave(4, 1)
        fg = (prob[i] >= s["seg_thr"]) & (ids > 0)
        pan = torch.where(fg, ids, torch.zeros_like(ids))[:oh, :ow]
        out[i] = _components(pan.cpu().numpy())
    return out


def _components(pan):
    """Split each value's pixels into 8-connected components."""
    out = np.zeros(pan.shape, np.int32)
    nxt = 1
    for v, sl in enumerate(ndimage.find_objects(pan), 1):
        if sl is None:
            continue
        lab, n = ndimage.label(pan[sl] == v, structure=EIGHT)
        sub = out[sl]
        sub[lab > 0] = lab[lab > 0] + (nxt - 1)
        nxt += n
    return out


# --- matching and tracking ----------------------------------------------

def _index(lab):
    """(labels present but 0, their areas, each label's position)."""
    cnt = np.bincount(lab.ravel())
    ids = np.flatnonzero(cnt)
    ids = ids[ids > 0]
    pos = np.zeros(len(cnt), np.int64)
    pos[ids] = np.arange(len(ids))
    return ids, cnt[ids].astype(float), pos


def _match(target, cur, iou_thr, ioa_thr, new_label):
    """Relabel ``cur`` (2D labels) after ``target`` (the neighbouring
    slice's final labels). ``new_label``: a callable for unmatched
    instances, or None to keep their labels."""
    c_ids, c_area, c_pos = _index(cur)
    if len(c_ids) == 0:
        return cur.astype(np.int64)
    t_ids, t_area, t_pos = _index(target)
    mapping = {}
    if len(t_ids):
        both = (cur > 0) & (target > 0)
        key = t_pos[target[both]] * len(c_ids) + c_pos[cur[both]]
        inter = np.bincount(key, minlength=len(t_ids) * len(c_ids)) \
            .reshape(len(t_ids), len(c_ids)).astype(float)
        union = t_area[:, None] + c_area[None, :] - inter
        iou = np.where(union > 0, inter / union, 0.0)
        rows, cols = linear_sum_assignment(iou, maximize=True)
        for r, c in zip(rows, cols):
            if iou[r, c] >= iou_thr:
                mapping[c_ids[c]] = t_ids[r]
        ioa = inter / c_area[None, :]
        best = ioa.argmax(0)
        for j, cid in enumerate(c_ids):
            if cid not in mapping and ioa[best[j], j] >= ioa_thr:
                mapping[cid] = t_ids[best[j]]
    lut = np.zeros(int(c_ids[-1]) + 1, np.int64)
    for cid in c_ids:
        lut[cid] = mapping[cid] if cid in mapping else (
            new_label() if new_label else cid)
    return lut[cur]


def _track(labels2d, s):
    """(n, H, W) 2D labels of one axis -> (n, H, W) 3D labels after the
    forward and the backward pass."""
    n = len(labels2d)
    out = np.zeros(labels2d.shape, np.int64)
    out[0] = labels2d[0]
    counter = [int(labels2d[0].max()) + 1]

    def new():
        counter[0] += 1
        return counter[0] - 1

    for z in range(1, n):
        out[z] = _match(out[z - 1], labels2d[z], s["iou_thr"],
                        s["ioa_thr"], new)
    for z in range(n - 2, -1, -1):
        out[z] = _match(out[z + 1], out[z], s["iou_thr"], s["ioa_thr"],
                        None)
    return out


def _filter(vol, min_size, min_span):
    """Drop labels under ``min_size`` voxels or spanning fewer than
    ``min_span`` along any axis; the kept ones are numbered from 1 in
    label order (int32)."""
    sizes = np.bincount(vol.ravel())
    keep = np.zeros(len(sizes), bool)
    for i, sl in enumerate(ndimage.find_objects(vol), 1):
        if sl is not None and sizes[i] >= min_size and \
                min(x.stop - x.start for x in sl) >= min_span:
            keep[i] = True
    lut = np.zeros(len(sizes), np.int32)
    lut[keep] = np.arange(1, keep.sum() + 1)
    return lut[vol]


def axis_instances(model, volume, axis, s, device, batch=8):
    """The instances of one axis as a label volume in volume order, and
    the axis's foreground probability there (after the median, in 255ths,
    uint8)."""
    slices = np.moveaxis(volume, axis, 0)
    prob, ctr, off = _maps(model, slices, s, device, batch)
    prob = _median_z(prob, s["qlen"])
    crop = slices.shape[1:]
    labels2d = np.concatenate([
        _slice_labels(prob[i:i + batch], ctr[i:i + batch], off[i:i + batch],
                      s, crop)
        for i in range(0, len(slices), batch)])
    p8 = (prob[:, :crop[0], :crop[1]] * 255).round().to(torch.uint8)
    p8 = np.moveaxis(p8.cpu().numpy(), 0, axis)
    del prob, ctr, off
    tracked = _track(labels2d, s)
    return np.moveaxis(_filter(tracked, s["min_size"], s["min_span"]), 0,
                       axis), p8


# --- orthoplane consensus -------------------------------------------------

def _pairs(a, b):
    """{(la, lb): voxels} over voxels where both volumes are labeled."""
    both = (a > 0) & (b > 0)
    key = a[both].astype(np.int64) * (int(b.max()) + 1) + b[both]
    keys, counts = np.unique(key, return_counts=True)
    m = int(b.max()) + 1
    return {(int(k // m), int(k % m)): int(c) for k, c in zip(keys, counts)}


def _components_of(nodes, adj):
    seen, comps = set(), []
    for start in nodes:
        if start in seen:
            continue
        comp, stack = [], [start]
        seen.add(start)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        comps.append(comp)
    return comps


def _merge_clusters(clusters, edges):
    """Most connected first: it takes its neighbours, unless its largest
    neighbour is larger, in which case its members join every
    neighbour and it goes."""
    nodes = list(range(len(clusters)))
    clusters = [set(c) for c in clusters]
    adj = {n: set() for n in nodes}
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    alive = list(nodes)
    while any(adj[n] for n in alive):
        mc = max(alive, key=lambda n: len(adj[n]))
        nbrs = sorted(adj[mc], key=lambda n: len(clusters[n]), reverse=True)
        if len(clusters[nbrs[0]]) > len(clusters[mc]):
            for nb in nbrs:
                clusters[nb] |= clusters[mc]
                adj[nb].discard(mc)
            adj[mc] = set()
            alive.remove(mc)
        else:
            for nb in nbrs:
                clusters[mc] |= clusters[nb]
                for x in adj[nb]:
                    if x != mc:
                        adj[x].discard(nb)
                adj[nb] = set()
                alive.remove(nb)
            adj[mc] = set()
    return [clusters[n] for n in alive]


def consensus(axis_vols, s):
    """Consensus label volume of the axes' label volumes."""
    n_axes = len(axis_vols)
    need = n_axes // 2 + 1
    cluster_thr = s["cluster_iou_thr"] if s["pixel_vote_thr"] >= need \
        else 0.0
    areas = [np.bincount(v.ravel()) for v in axis_vols]
    boxes = [ndimage.find_objects(v) for v in axis_vols]
    nodes = [(a, int(l)) for a in range(n_axes)
             for l in range(1, len(areas[a])) if areas[a][l] > 0]
    adj = {n: {} for n in nodes}
    for a in range(n_axes):
        for b in range(a + 1, n_axes):
            for (la, lb), inter in _pairs(axis_vols[a], axis_vols[b]).items():
                union = areas[a][la] + areas[b][lb] - inter
                e = (inter / union, inter)
                adj[(a, la)][(b, lb)] = e
                adj[(b, lb)][(a, la)] = e
    out = np.zeros(axis_vols[0].shape, np.int32)
    next_id = 1
    for comp in _components_of(nodes, adj):
        if len(comp) < need:
            continue
        strong = {u: {v for v, e in adj[u].items() if e[0] > cluster_thr}
                  for u in comp}
        clusters = _components_of(comp, strong)
        where = {u: i for i, c in enumerate(clusters) for u in c}
        sums = {}
        for u in comp:
            for v, (iou, inter) in adj[u].items():
                cu, cv = where[u], where[v]
                if cu < cv:
                    acc = sums.setdefault((cu, cv), [0.0, 0.0])
                    acc[0] += iou
                    acc[1] += inter
        edges = [k for k, (iou, ov) in sorted(sums.items())
                 if iou / (len(clusters[k[0]]) * len(clusters[k[1]]))
                 > MIN_IOU or ov / (len(clusters[k[0]])
                                    * len(clusters[k[1]])) > MIN_OVERLAP]
        voted = []
        for cluster in _merge_clusters(clusters, edges):
            if len(cluster) < need:
                continue
            sl = _box([boxes[a][l - 1] for a, l in cluster])
            votes = np.zeros([x.stop - x.start for x in sl], np.int32)
            for a, l in cluster:
                votes += axis_vols[a][sl] == l
            mask = votes >= s["pixel_vote_thr"]
            if mask.any():
                voted.append((sl, mask))
        for sl, mask in _merge_overlapping(voted):
            out[sl][mask] = next_id
            next_id += 1
    return _filter(out, s["min_size"], s["min_span"])


def _box(slices):
    return tuple(slice(min(s[i].start for s in slices),
                       max(s[i].stop for s in slices)) for i in range(3))


def _merge_overlapping(voted):
    """Union the voted instances that overlap by IoU above MIN_IOU or by
    more than MIN_OVERLAP voxels (and what overlaps those)."""
    n = len(voted)
    adj = {i: set() for i in range(n)}
    for i in range(n):
        for j in range(i + 1, n):
            box = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                        for a, b in zip(voted[i][0], voted[j][0]))
            if any(x.stop <= x.start for x in box):
                continue
            mi = voted[i][1][tuple(slice(x.start - a.start, x.stop - a.start)
                                   for x, a in zip(box, voted[i][0]))]
            mj = voted[j][1][tuple(slice(x.start - a.start, x.stop - a.start)
                                   for x, a in zip(box, voted[j][0]))]
            inter = int((mi & mj).sum())
            union = int(voted[i][1].sum()) + int(voted[j][1].sum()) - inter
            if inter > MIN_OVERLAP or (union and inter / union > MIN_IOU):
                adj[i].add(j)
                adj[j].add(i)
    merged = []
    for comp in _components_of(range(n), adj):
        sl = _box([voted[i][0] for i in comp])
        mask = np.zeros([x.stop - x.start for x in sl], bool)
        for i in comp:
            inner = tuple(slice(a.start - b.start, a.stop - b.start)
                          for a, b in zip(voted[i][0], sl))
            mask[inner] |= voted[i][1]
        merged.append((sl, mask))
    return merged


def segment(model, volume, s, device, batch=8):
    """The answer for ``volume``: a label volume of its instances (stack:
    the xy axis's; orthoplane: the consensus of xy, xz and yz), and each
    axis's foreground probability (uint8 255ths)."""
    axes = [0] if s["mode"] == "stack" else [0, 1, 2]
    out = [axis_instances(model, volume, a, s, device, batch) for a in axes]
    vols, probs = [o[0] for o in out], [o[1] for o in out]
    return (vols[0] if s["mode"] == "stack" else consensus(vols, s)), probs


def confident(probs, thr, margin):
    """Voxels that every axis puts on the same side of ``thr`` by at least
    ``margin`` in probability."""
    lo, hi = (thr - margin) * 255, (thr + margin) * 255
    fg = np.ones(probs[0].shape, bool)
    bg = np.ones(probs[0].shape, bool)
    for p in probs:
        fg &= p >= hi
        bg &= p <= lo
    return fg | bg


# --- comparison -------------------------------------------------------------

def compare_labels(got, want, iou=0.5, probs=None, thr=0.5, margin=0.1,
                   share=0.5):
    """Numbers of label volume ``got`` against ``want`` (0 for the same
    partition): instances pair up where their IoU is above ``iou`` (at
    most one partner each);

    - ``voxels``: one minus the paired 3D instances' shared voxels over
      the union of both foregrounds;
    - ``instances``: one minus the F1 of the 3D pairing;
    - ``slices``: one minus the F1 of the pairing of 2D instances, slice
      by slice along the first axis;
    - ``foreground``: the voxels in one foreground only, over the union
      of both.

    With ``probs``, the reference's per-axis probabilities, a voxel is
    sure where every axis puts it on one side of ``thr`` by at least
    ``margin``, and:

    - ``confident_<margin in hundredths>``: the voxels in one foreground
      only that are sure, over the union of both foregrounds;
    - ``voxels_sure``: ``voxels`` over the sure voxels alone;
    - ``instances_sure_<share in hundredths>`` and ``slices_sure_<...>``:
      ``instances`` and ``slices`` over the instances of which at least
      ``share`` of the voxels are sure, on either side, and their
      partners."""
    ga = np.bincount(got.ravel())
    wa = np.bincount(want.ravel())
    shared, pairs = 0, []
    for (g, w), inter in _pairs(got, want).items():
        if inter / (ga[g] + wa[w] - inter) > iou:
            shared += inter
            pairs.append((g, w))
    fg_got, fg_want = got > 0, want > 0
    union = int((fg_got | fg_want).sum())
    n_got = int((ga[1:] > 0).sum())
    n_want = int((wa[1:] > 0).sum())
    out = {
        "voxels": 1.0 - shared / union if union else 0.0,
        "instances": _miss(len(pairs), n_got + n_want),
        "slices": _slice_miss(got, want, iou),
        "foreground": int((fg_got ^ fg_want).sum()) / union if union
        else 0.0,
    }
    if probs is not None:
        sure = confident(probs, thr, margin)
        out[f"confident_{round(margin * 100)}"] = int(
            ((fg_got ^ fg_want) & sure).sum()) / union if union else 0.0
        out["voxels_sure"] = _voxels_sure(got, want, pairs, sure)
        tag = round(share * 100)
        out[f"instances_sure_{tag}"] = _sure_miss(
            pairs, _sure_ids(got.ravel(), sure.ravel(), share),
            _sure_ids(want.ravel(), sure.ravel(), share))
        out[f"slices_sure_{tag}"] = _slice_miss(got, want, iou, sure, share)
    return out


def _voxels_sure(got, want, pairs, sure):
    """One minus the sure voxels that paired instances share, over the
    sure voxels of the union of both foregrounds."""
    union = int((((got > 0) | (want > 0)) & sure).sum())
    if not union:
        return 0.0
    both = (got > 0) & (want > 0) & sure
    m = int(want.max()) + 1
    keys, counts = np.unique(got[both].astype(np.int64) * m + want[both],
                             return_counts=True)
    paired = np.array([g * m + w for g, w in pairs], np.int64)
    return 1.0 - int(counts[np.isin(keys, paired)].sum()) / union


def _miss(paired, total):
    return 1.0 - 2 * paired / total if total else 0.0


def _sure_ids(keys, sure, share):
    """The nonzero values of ``keys`` (int, flat) of which at least
    ``share`` of the positions are in ``sure`` (bool, flat)."""
    keys = np.asarray(keys, np.int64)
    total = np.bincount(keys)
    inside = np.bincount(keys[sure], minlength=len(total))
    ids = np.flatnonzero((total > 0) & (inside >= share * total))
    return set(ids[ids > 0].tolist())


def _sure_miss(pairs, sure_got, sure_want):
    """One minus the F1 over the sure instances of either side, each
    with its partner."""
    got, want, paired = set(sure_got), set(sure_want), 0
    for g, w in pairs:
        if g in got or w in want:
            got.add(g)
            want.add(w)
            paired += 1
    return _miss(paired, len(got) + len(want))


def _slice_miss(got, want, iou, sure=None, share=0.5):
    """One minus the F1 of 2D instances paired within each slice (with
    ``sure``: over the sure 2D instances and their partners)."""
    z = np.arange(got.shape[0], dtype=np.int64)[:, None, None]
    mg, mw = int(got.max()) + 1, int(want.max()) + 1
    kg = (z * mg + got)[got > 0]
    kw = (z * mw + want)[want > 0]
    ug, cg = np.unique(kg, return_counts=True)
    uw, cw = np.unique(kw, return_counts=True)
    both = (got > 0) & (want > 0)
    zb = np.broadcast_to(z, got.shape)[both]
    g, w = got[both].astype(np.int64), want[both].astype(np.int64)
    keys, inter = np.unique((zb * mg + g) * mw + w, return_counts=True)
    area_g = cg[np.searchsorted(ug, keys // mw)]
    area_w = cw[np.searchsorted(uw, (keys // mw // mg) * mw + keys % mw)]
    hit = inter / (area_g + area_w - inter) > iou
    if sure is None:
        return _miss(int(hit.sum()), len(ug) + len(uw))
    # number the 2D instances of each side 1..n in key order
    pg = np.searchsorted(ug, keys[hit] // mw) + 1
    pw = np.searchsorted(uw, (keys[hit] // mw // mg) * mw
                         + keys[hit] % mw) + 1
    sg = _sure_ids(np.searchsorted(ug, kg) + 1, sure[got > 0], share)
    sw = _sure_ids(np.searchsorted(uw, kw) + 1, sure[want > 0], share)
    return _sure_miss(zip(pg.tolist(), pw.tolist()), sg, sw)
