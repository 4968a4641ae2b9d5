"""Panoptic post-processing on the device, batched over slices.

Semantics match the JAX package's ``ops/postprocess.py`` (ids, ordering
and tie-breaks identical):

- ``find_instance_centers``: threshold + max-pool NMS, an exact top-k
  whose ties go to the lower flat index, padding to ``max_centers``,
  then valid centers reordered by flat index;
- ``group_pixels``: nearest offset-shifted center (``ops/group.py``,
  the CUDA kernel on the card);
- the merges: a (instance, class) vote table by ``scatter_add_``, the
  majority class by first-max argmax, per-class 1-based renumbering in
  instance order, then the panoptic paint.

pan_id = class_id * label_divisor + instance_id. Every function takes a
leading batch dim B; semantic maps are NCHW, offsets (B, H, W, 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from empanada_torch.models.point_rend import topk_lower_index
from empanada_torch.ops.group import group_pixels_batched

__all__ = [
    "logits_to_prob",
    "harden_semantic",
    "median_small",
    "find_instance_centers",
    "group_pixels",
    "merge_semantic_and_instance",
    "merge_semantic_and_instance_coarse",
    "get_panoptic_segmentation",
    "thing_table",
]

_INT32_MAX = 2 ** 31 - 1


def median_small(window: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Elementwise median over a small odd window dim (the middle of a
    sort)."""
    k = window.shape[dim]
    return window.sort(dim=dim).values.select(dim, k // 2)


def logits_to_prob(logits: torch.Tensor) -> torch.Tensor:
    """softmax over channels (multiclass) or sigmoid (binary). NCHW."""
    if logits.shape[1] > 1:
        return torch.softmax(logits, dim=1)
    return torch.sigmoid(logits)


def harden_semantic(sem_prob: torch.Tensor, confidence_thr: float = 0.5):
    """(B, C, H, W) probabilities -> (B, H, W) int32 class ids."""
    if sem_prob.shape[1] > 1:
        return torch.argmax(sem_prob, dim=1).to(torch.int32)
    return (sem_prob[:, 0] >= confidence_thr).to(torch.int32)


def find_instance_centers(ctr_hmp: torch.Tensor, threshold: float = 0.1,
                          nms_kernel: int = 7, max_centers: int = 256):
    """Center NMS with a static-size output.

    ctr_hmp: (B, H, W) raw heatmaps. Returns centers (B, max_centers, 2)
    int32 (y, x) and valid (B, max_centers) bool; valid centers come
    first, in ascending flat index (row-major scan order)."""
    b, h, w = ctr_hmp.shape
    x = torch.where(ctr_hmp > threshold, ctr_hmp,
                    torch.full_like(ctr_hmp, -1.0))
    pad = nms_kernel // 2
    pooled = F.max_pool2d(x[:, None], nms_kernel, stride=1, padding=pad)[:, 0]
    is_peak = (x == pooled) & (x > 0)
    scores = torch.where(is_peak, x, torch.full_like(x, float("-inf")))
    scores = scores.reshape(b, h * w)
    k = min(max_centers, h * w)
    top_scores, top_idx = topk_lower_index(scores, k)
    if k < max_centers:
        fill = max_centers - k
        top_scores = torch.cat([top_scores, top_scores.new_full(
            (b, fill), float("-inf"))], dim=1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((b, fill))], dim=1)
    valid = top_scores > 0
    sort_key = torch.where(valid, top_idx, torch.full_like(top_idx,
                                                           _INT32_MAX))
    order = torch.sort(sort_key, dim=1, stable=True).indices
    top_idx = torch.gather(top_idx, 1, order)
    valid = torch.gather(valid, 1, order)
    centers = torch.stack([top_idx // w, top_idx % w], dim=-1)
    return centers.to(torch.int32), valid


def group_pixels(centers, valid, offsets, step: float = 1.0):
    """(B, K, 2) centers, (B, K) valid, (B, H, W, 2) offsets ->
    (B, H, W) int32 1-based nearest-center ids (0 only where a slice has
    no valid center). One kernel launch for the whole batch on CUDA."""
    return group_pixels_batched(centers.to(torch.int32).contiguous(),
                                valid.contiguous(),
                                offsets.float().contiguous(), step)


def thing_table(thing_list, num_classes, device):
    """(num_classes,) bool table, True for thing classes."""
    table = torch.zeros(num_classes, dtype=torch.bool, device=device)
    for t in thing_list:
        table[t] = True
    return table


def _instance_paint_tables(counts):
    """Per-instance (majority class, per-class 1-based renumbering) from
    (B, K+1, C) vote counts; both (B, K+1) int32, new id 0 marks absent
    instances."""
    counts = counts.clone()
    counts[:, 0] = 0
    inst_area = counts.sum(dim=2)
    inst_class = torch.argmax(counts, dim=2).to(torch.int32)
    present = inst_area > 0
    kk = counts.shape[1]
    same = inst_class[:, :, None] == inst_class[:, None, :]
    ar = torch.arange(kk, device=counts.device)
    lower = ar[None, :] < ar[:, None]
    prior = (same & lower[None] & present[:, None, :]).sum(dim=2)
    new_id = torch.where(present, prior.to(torch.int32) + 1,
                         torch.zeros_like(inst_class))
    return inst_class, new_id


def _paint_panoptic(sem, ins, paint, thing_table, label_divisor, stuff_area,
                    void_label, num_classes):
    """Full-res semantics + per-pixel instance paint (pan id of the
    instance at the pixel, 0 if absent) -> (B, H, W) int32 pan map."""
    b = sem.shape[0]
    sem_l = sem.long()
    is_thing_px = thing_table[sem_l]
    thing_seg = is_thing_px & (ins > 0)
    stuff_px = ~thing_seg
    class_area = torch.zeros((b, num_classes), dtype=torch.int64,
                             device=sem.device)
    class_area.scatter_add_(1, sem_l.reshape(b, -1),
                            stuff_px.reshape(b, -1).long())
    stuff_keep = (~thing_table)[None] & (class_area >= stuff_area)
    keep_px = torch.gather(stuff_keep, 1, sem_l.reshape(b, -1)).reshape(
        sem.shape)
    pan = torch.full_like(sem, void_label, dtype=torch.int32)
    pan = torch.where(stuff_px & keep_px, (sem * label_divisor).int(), pan)
    return torch.where(thing_seg & (paint > 0), paint.int(), pan)


def _paint_values(cls_tbl, nid_tbl, ins, label_divisor):
    """paint[p] = cls*label_divisor + nid of the instance at p (0 where
    absent), via per-slice table gathers."""
    b = ins.shape[0]
    flat = ins.reshape(b, -1).long()
    cls = torch.gather(cls_tbl, 1, flat)
    nid = torch.gather(nid_tbl, 1, flat)
    paint = torch.where(nid > 0, cls * label_divisor + nid,
                        torch.zeros_like(nid))
    return paint.reshape(ins.shape)


def merge_semantic_and_instance(sem, ins, label_divisor, thing_table,
                                stuff_area, void_label, max_centers,
                                num_classes):
    """Panoptic merge at full resolution.

    sem, ins: (B, H, W) int32 (ins values <= max_centers);
    thing_table: (num_classes,) bool. Returns (B, H, W) int32."""
    b = sem.shape[0]
    kk = max_centers + 1
    sem_f = sem.reshape(b, -1).long()
    is_thing_px = thing_table[sem_f]
    ins_f = torch.where(is_thing_px, ins.reshape(b, -1).long(),
                        torch.zeros_like(sem_f))
    vote = ins_f > 0
    bins = torch.where(vote, ins_f * num_classes + sem_f,
                       torch.full_like(sem_f, kk * num_classes))
    counts = torch.zeros((b, kk * num_classes + 1), dtype=torch.int64,
                         device=sem.device)
    counts.scatter_add_(1, bins, torch.ones_like(bins))
    counts = counts[:, :-1].reshape(b, kk, num_classes)
    cls_tbl, nid_tbl = _instance_paint_tables(counts)
    paint = _paint_values(cls_tbl, nid_tbl, ins, label_divisor)
    return _paint_panoptic(sem, ins, paint, thing_table, label_divisor,
                           stuff_area, void_label, num_classes)


def merge_semantic_and_instance_coarse(sem, ins_coarse, scale, label_divisor,
                                       thing_table, stuff_area, void_label,
                                       max_centers, num_classes):
    """Render-path merge: instance ids are constant over scale x scale
    cells, so the vote table and the paint lookup run on the coarse grid.

    sem: (B, H, W) int32 with H, W divisible by scale; ins_coarse:
    (B, H/scale, W/scale) int32. Same result as
    ``merge_semantic_and_instance`` on the upsampled ids."""
    b, h, w = sem.shape
    hc, wc = h // scale, w // scale
    kk = max_centers + 1
    ins_flat = ins_coarse.reshape(b, -1).long()
    cells = sem.reshape(b, hc, scale, wc, scale)
    counts = torch.zeros((b, kk * num_classes + 1), dtype=torch.int64,
                         device=sem.device)
    dump = kk * num_classes
    for c in range(num_classes):
        # only thing classes vote
        cell_cnt = (cells == c).sum(dim=(2, 4)).reshape(b, -1) \
            * thing_table[c]
        bins = torch.where(ins_flat > 0, ins_flat * num_classes + c,
                           torch.full_like(ins_flat, dump))
        counts.scatter_add_(1, bins, cell_cnt)
    counts = counts[:, :-1].reshape(b, kk, num_classes)
    cls_tbl, nid_tbl = _instance_paint_tables(counts)
    paint_c = _paint_values(cls_tbl, nid_tbl, ins_coarse, label_divisor)

    def up(t):
        return t.repeat_interleave(scale, dim=1).repeat_interleave(scale,
                                                                   dim=2)

    return _paint_panoptic(sem, up(ins_coarse), up(paint_c), thing_table,
                           label_divisor, stuff_area, void_label, num_classes)


def get_panoptic_segmentation(sem_prob, ctr_hmp, offsets, thing_list,
                              label_divisor=1000, stuff_area=64, void_label=0,
                              threshold=0.1, nms_kernel=7, confidence_thr=0.5,
                              max_centers=256, num_classes=None):
    """Full panoptic pipeline for a batch of single-resolution maps.

    sem_prob: (B, C, H, W) probabilities; ctr_hmp: (B, H, W); offsets:
    (B, H, W, 2). Returns (B, H, W) int32 panoptic ids."""
    if num_classes is None:
        num_classes = max(int(sem_prob.shape[1]), max(thing_list) + 1, 2)
    sem = harden_semantic(sem_prob, confidence_thr)
    centers, valid = find_instance_centers(ctr_hmp, threshold, nms_kernel,
                                           max_centers)
    ins = group_pixels(centers, valid, offsets)
    table = thing_table(thing_list, num_classes, sem.device)
    ins = torch.where(table[sem.long()], ins, torch.zeros_like(ins))
    return merge_semantic_and_instance(sem, ins, label_divisor, table,
                                       stuff_area, void_label, max_centers,
                                       num_classes)
