"""Dataset-curation toolkit (the reference's mitonet data-ops scripts),
the JAX package's ``data/curation.py`` in the port:

- perceptual-hash patch deduplication (reference
  projects/mitonet/scripts/legacy_data/deduplicate3d_with_masks.py:50-130:
  dhash per grid patch, greedy exemplar sets by Hamming distance under a
  random ordering);
- flipbook extraction for annotation (reference
  zooniverse/create_flipbooks.py: short z-stacks around locations);
- proofread-stack splitting (reference zooniverse/split_proof_stack.py:
  middle slice of each flipbook, its mask, the annotator's median
  confidence);
- annotation-batch merging and regrouping (reference
  zooniverse/merge_zoo_segs.py:38-86, group_tem_segs.py,
  legacy_data/organize_from_deduplicated.py: the
  {dataset}/images+masks+confidences.json layout the training datasets
  read);
- patch-quality filtering (reference legacy_data/filter_nn.py: a
  resnet34 binary classifier scores patches), batched on the card.

Confidences are JSON end to end. Images are written as uncompressed
TIFF (``image_files.write_tiff``) where the JAX package calls
``cv2.imwrite``; the pixels are the same. The hash's INTER_AREA resize
and the filter's INTER_LINEAR resize are cv2's kernels reproduced in
numpy (``data.utils.transforms``): no OpenCV.
"""

from __future__ import annotations

import json
import os
import shutil
from glob import glob

import numpy as np
import torch
from torch import nn

from empanada_torch.data.image_files import write_tiff
from empanada_torch.data.utils.transforms import resize_area, resize_linear

__all__ = [
    "dhash", "patch_and_hash", "deduplicate_hashes",
    "flipbooks_from_locations", "split_proof_stack",
    "merge_annotation_batch", "group_annotation_dirs",
    "organize_patches", "PatchQualityFilter", "dataset_name_from_file",
]


# ---------------------------------------------------------------------
# perceptual hashing + dedup


def dhash(image, hash_size=8):
    """Difference hash: resize to (hash_size+1, hash_size) grayscale (cv2's
    INTER_AREA on float32) and compare horizontally adjacent pixels ->
    (hash_size, hash_size) bool (reference
    deduplicate3d_with_masks.py:50-55 via imagehash.dhash)."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image.mean(axis=-1)
    small = resize_area(image.astype(np.float32), (hash_size,
                                                   hash_size + 1))
    return small[:, 1:] > small[:, :-1]


def patch_and_hash(image, mask=None, crop_size=512, hash_size=8,
                   relabel=True):
    """Split an image (+ mask) into a near-``crop_size`` grid and hash
    each patch (reference deduplicate3d_with_masks.py:57-95: round(size /
    crop_size) tiles per axis, remainder merged into the last tile).

    Returns dict with 'patches', 'patch_masks', 'hashes', 'locs'.
    """
    from empanada_torch.core.ccl import connected_components_2d

    image = np.asarray(image)
    if image.ndim == 3:
        image = image[..., 0]
    ysize, xsize = image.shape
    ny = max(1, int(round(ysize / crop_size)))
    nx = max(1, int(round(xsize / crop_size)))

    out = {"patches": [], "patch_masks": [], "hashes": [], "locs": []}
    for y in range(ny):
        ys = y * crop_size
        ye = min(ys + crop_size, ysize) if y < ny - 1 else ysize
        for x in range(nx):
            xs = x * crop_size
            xe = min(xs + crop_size, xsize) if x < nx - 1 else xsize
            patch = image[ys:ye, xs:xe]
            out["patches"].append(patch)
            out["hashes"].append(dhash(patch, hash_size))
            out["locs"].append(f"{ys}-{ye}_{xs}-{xe}")
            if mask is not None:
                pm = np.asarray(mask[ys:ye, xs:xe])
                if relabel:
                    pm = connected_components_2d(
                        pm.astype(np.int32)).astype(np.uint16)
                out["patch_masks"].append(pm)
    return out


def deduplicate_hashes(hashes, min_distance=12, seed=0):
    """Greedy exemplar selection: random ordering, each unassigned hash
    claims every hash within ``min_distance`` Hamming bits (reference
    deduplicate3d_with_masks.py:97-130). Returns exemplar indices into
    the ORIGINAL hash list."""
    hashes = np.asarray([np.asarray(h).reshape(-1) for h in hashes])
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(hashes))
    remaining = list(order)
    exemplars = []
    while remaining:
        ref = remaining[0]
        dist = np.logical_xor(hashes[ref], hashes[remaining]).sum(1)
        matched = dist <= min_distance
        exemplars.append(int(ref))
        remaining = [r for r, m in zip(remaining, matched) if not m]
    return sorted(exemplars)


# ---------------------------------------------------------------------
# flipbooks


def flipbooks_from_locations(volume, centers, span=5, size=224):
    """Extract (span, size, size) z-stacks centered on (z, y, x)
    locations, zero-padded at volume borders (reference
    create_flipbooks.py reconstruction crops). span must be odd."""
    if span % 2 != 1:
        raise ValueError("flipbook span must be odd")
    volume = np.asarray(volume)
    n, h, w = volume.shape
    half, hs = span // 2, size // 2
    books = np.zeros((len(centers), span, size, size), volume.dtype)
    for i, (z, y, x) in enumerate(centers):
        z0, z1 = z - half, z + half + 1
        y0, x0 = y - hs, x - hs
        sz0, sz1 = max(z0, 0), min(z1, n)
        sy0, sy1 = max(y0, 0), min(y0 + size, h)
        sx0, sx1 = max(x0, 0), min(x0 + size, w)
        books[i, sz0 - z0:sz1 - z0, sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] \
            = volume[sz0:sz1, sy0:sy1, sx0:sx1]
    return books


# ---------------------------------------------------------------------
# proofread-stack splitting + batch organization


def split_proof_stack(image_stack, mask_stack, attrs, save_dir,
                      ignore=()):
    """Split proofread flipbook stacks into per-image files: the middle
    slice of each flipbook, its (uint8-safe) mask, and the annotator's
    median confidence (reference split_proof_stack.py:39-77; confidence
    as JSON, not pickle). ``attrs``: iterable of dicts with image_name /
    start / end / median_confidence (+ optional height / width)."""
    image_stack = np.asarray(image_stack)
    mask_stack = np.asarray(mask_stack)
    if len(image_stack) != len(mask_stack):
        raise ValueError(f"{len(image_stack)} images, {len(mask_stack)} "
                         "masks")
    for sub in ("images", "masks", "confs"):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    written = []
    for idx, a in enumerate(attrs):
        if idx in ignore:
            continue
        fname = ".".join(str(a["image_name"]).split(".")[:-1]) \
            or str(a["image_name"])
        start, end = int(a["start"]), int(a["end"])
        stack_idx = start + (end - start) // 2
        im = image_stack[stack_idx]
        if "height" in a:
            h, w = int(a["height"]), int(a["width"])
        else:  # recover the pre-padding extent from content
            nz_y = np.any(im, axis=1).nonzero()[0]
            nz_x = np.any(im, axis=0).nonzero()[0]
            h = int(nz_y[-1]) + 1 if len(nz_y) else im.shape[0]
            w = int(nz_x[-1]) + 1 if len(nz_x) else im.shape[1]
        msk = mask_stack[stack_idx, :h, :w]
        if msk.max() >= 256:
            raise ValueError(f"{fname}: mask ids must stay 8-bit")
        write_tiff(os.path.join(save_dir, f"images/{fname}.tiff"),
                   im[:h, :w])
        write_tiff(os.path.join(save_dir, f"masks/{fname}.tiff"),
                   msk.astype(np.uint8))
        with open(os.path.join(save_dir, f"confs/{fname}.json"), "w") as f:
            json.dump(int(a["median_confidence"]), f)
        written.append(fname)
    return written


def dataset_name_from_file(filename):
    """Strip crop-trail suffixes to recover the source dataset name
    (reference merge_zoo_segs.py:50-59 / organize_from_deduplicated
    .py:28-36)."""
    name = os.path.basename(filename)
    for marker in ("-ROI-", "-LOC-2d-", "-LOC-"):
        if marker in name:
            return name.split(marker)[0]
    return ".".join(name.split(".")[:-1]) or name


def _load_conf(path):
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def merge_annotation_batch(src_dir, dst_dir, mask_dirname="masks"):
    """Fold one proofread batch (images/ masks/ confs/) into the
    per-dataset training layout {dataset}/{images,masks,confidences.json}
    (reference merge_zoo_segs.py:38-86)."""
    imdir = os.path.join(src_dir, "images")
    mkdir = os.path.join(src_dir, mask_dirname)
    cfdir = os.path.join(src_dir, "confs")
    impaths = sorted(glob(os.path.join(imdir, "*.tiff")))

    touched = set()
    for imp in impaths:
        base = os.path.basename(imp)
        stem = ".".join(base.split(".")[:-1])
        dataset = dataset_name_from_file(base)
        ddir = os.path.join(dst_dir, dataset)
        os.makedirs(os.path.join(ddir, "images"), exist_ok=True)
        os.makedirs(os.path.join(ddir, "masks"), exist_ok=True)

        conf_path = os.path.join(ddir, "confidences.json")
        conf = _load_conf(conf_path)
        with open(os.path.join(cfdir, f"{stem}.json")) as f:
            conf[base] = json.load(f)
        with open(conf_path, "w") as f:
            json.dump(conf, f, indent=2)

        shutil.copy(imp, os.path.join(ddir, "images", base))
        shutil.copy(os.path.join(mkdir, base),
                    os.path.join(ddir, "masks", base))
        touched.add(dataset)
    return sorted(touched)


def group_annotation_dirs(src_dir, converter):
    """Regroup randomized annotation subdirectories under their true
    dataset names, merging confidences (reference group_tem_segs.py:
    31-55). ``converter``: {random_prefix: destination_name}."""
    for sd, dst_sd in converter.items():
        sdir = os.path.join(src_dir, sd)
        if not os.path.isdir(sdir):
            continue
        conf = _load_conf(os.path.join(sdir, "confidences.json"))
        ddir = os.path.join(src_dir, dst_sd)
        os.makedirs(os.path.join(ddir, "images"), exist_ok=True)
        os.makedirs(os.path.join(ddir, "masks"), exist_ok=True)
        dst_conf = _load_conf(os.path.join(ddir, "confidences.json"))
        with open(os.path.join(ddir, "confidences.json"), "w") as f:
            json.dump({**dst_conf, **conf}, f, indent=2)
        for name in conf:
            for sub in ("images", "masks"):
                os.rename(os.path.join(sdir, sub, name),
                          os.path.join(ddir, sub, name))


def organize_patches(patch_dicts, save_dir):
    """Write deduplicated patch dicts into the per-dataset layout
    (reference organize_from_deduplicated.py:27-65). ``patch_dicts``:
    {source_filename: {'names': [...], 'patches': [...],
    'patch_masks': [...]}}."""
    for src_name, pd in patch_dicts.items():
        dataset = dataset_name_from_file(src_name)
        ddir = os.path.join(save_dir, dataset)
        os.makedirs(os.path.join(ddir, "images"), exist_ok=True)
        masks = pd.get("patch_masks") or None
        if masks is not None:
            os.makedirs(os.path.join(ddir, "masks"), exist_ok=True)
        for j, (fn, img) in enumerate(zip(pd["names"], pd["patches"])):
            ip = os.path.join(ddir, f"images/{fn}.tiff")
            if os.path.exists(ip):
                continue
            write_tiff(ip, np.asarray(img))
            if masks is not None:
                write_tiff(os.path.join(ddir, f"masks/{fn}.tiff"),
                           np.asarray(masks[j]))


# ---------------------------------------------------------------------
# patch-quality filtering (batched on the card)


class _Classifier(nn.Module):
    """The encoder, a mean pool of its last feature map and one logit;
    children named as flax names them (``ResNet_0``, ``Dense_0``), so
    ``weights.flax_to_torch`` carries the JAX filter's variables."""

    def __init__(self, encoder_name):
        from empanada_torch.models.encoders import get_encoder

        super().__init__()
        self.ResNet_0 = get_encoder(encoder_name)
        self.Dense_0 = nn.Linear(self.ResNet_0.out_channels[-1], 1)

    def forward(self, x):
        pooled = self.ResNet_0(x)[-1].mean(dim=(2, 3))
        return self.Dense_0(pooled)[:, 0]


class PatchQualityFilter:
    """Binary informative/uninformative patch classifier (reference
    filter_nn.py:54-149: resnet34 + 1-logit head over 224^2 patches),
    scored in batches on ``device`` (CUDA unless named; raises without a
    card when none is named). ``state_dict``: the classifier's weights
    (for example ``flax_to_torch`` of the JAX filter's variables); None
    draws a seeded init."""

    def __init__(self, encoder="resnet34", imsize=224, state_dict=None,
                 seed=0, device=None):
        from empanada_torch.device import resolve_device
        from empanada_torch.models import init_train_

        self.device = resolve_device(device)
        self.imsize = imsize
        model = _Classifier(encoder)
        if state_dict is None:
            init_train_(model, seed)
            gen = torch.Generator().manual_seed(seed + 1)
            dense = model.Dense_0
            with torch.no_grad():
                dense.weight.copy_(torch.randn(dense.weight.shape,
                                               generator=gen)
                                   / dense.weight.shape[1] ** 0.5)
                dense.bias.zero_()
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    def _prep(self, patches):
        """(N, 1, imsize, imsize) float32: each patch resized with cv2's
        INTER_LINEAR (half-pixel centres, no antialias) and scaled to
        [0, 1] on its own, so a patch's score does not depend on which
        other patches share the call."""
        xs = np.stack([
            resize_linear(np.asarray(p, np.float32),
                          (self.imsize, self.imsize))
            for p in patches
        ])[:, None]
        lo = xs.min(axis=(1, 2, 3), keepdims=True)
        hi = xs.max(axis=(1, 2, 3), keepdims=True)
        return (xs - lo) / np.maximum(hi - lo, 1e-6)

    def predict(self, patches, batch_size=64):
        """Confidence that each patch is informative, in [0, 1]."""
        xs = self._prep(patches)
        out = []
        with torch.inference_mode():
            for i in range(0, len(xs), batch_size):
                batch = torch.from_numpy(xs[i:i + batch_size]).to(
                    self.device)
                out.append(torch.sigmoid(self.model(batch)).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def filter(self, patches, confidence_thr=0.5, keep_frac=0.1, seed=0):
        """Split indices into (informative, rejected, scores): score >= thr
        keeps a patch; a ``keep_frac`` random sample of the rejects is
        retained as negatives (reference filter_nn.py keep_thr)."""
        scores = self.predict(patches)
        keep = scores >= confidence_thr
        rng = np.random.default_rng(seed)
        rescued = (~keep) & (rng.random(len(scores)) < keep_frac)
        keep_idx = np.flatnonzero(keep | rescued)
        drop_idx = np.flatnonzero(~(keep | rescued))
        return keep_idx, drop_idx, scores
