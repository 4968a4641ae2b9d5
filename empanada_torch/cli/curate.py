"""``python -m empanada_torch curate <subcommand>``: the dataset-curation
commands (the reference's mitonet data-ops scripts as subcommands; see
``data/curation.py`` for each script's citation).

Subcommands:
  dedup        hash + deduplicate grid patches of images in a directory
  flipbooks    extract annotation flipbooks around candidate locations
  split-stack  split a proofread flipbook stack into images/masks/confs
  merge-batch  fold a proofread batch into the per-dataset train layout
  group-dirs   regroup randomized annotation dirs by true dataset name
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="empanada-curate")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dedup", help="patch-hash deduplication")
    d.add_argument("image_dir")
    d.add_argument("save_dir")
    d.add_argument("--mask-dir", default=None)
    d.add_argument("--crop-size", type=int, default=512)
    d.add_argument("--hash-size", type=int, default=8)
    d.add_argument("--min-distance", type=int, default=12)

    f = sub.add_parser("flipbooks", help="extract annotation flipbooks")
    f.add_argument("volume")
    f.add_argument("locations", help="JSON list of [z, y, x] centers")
    f.add_argument("save_path", help=".npy output (N, span, size, size)")
    f.add_argument("--span", type=int, default=5)
    f.add_argument("--size", type=int, default=224)

    s = sub.add_parser("split-stack", help="split proofread stack")
    s.add_argument("image_stack", help=".npy image stack")
    s.add_argument("mask_stack", help=".npy mask stack")
    s.add_argument("attributes", help="JSON list of flipbook attributes")
    s.add_argument("save_dir")
    s.add_argument("--ignore", type=int, nargs="+", default=[])

    m = sub.add_parser("merge-batch", help="merge proofread batch")
    m.add_argument("src_dir")
    m.add_argument("dst_dir")
    m.add_argument("--mask-dirname", default="masks")

    g = sub.add_parser("group-dirs", help="regroup annotation dirs")
    g.add_argument("src_dir")
    g.add_argument("conversion", help="JSON {random_prefix: dataset}")
    return p.parse_args(argv)


def _dedup(args):
    from empanada_torch.data import curation as cur
    from empanada_torch.data.image_files import read_image, read_mask

    os.makedirs(args.save_dir, exist_ok=True)
    for imp in sorted(glob(os.path.join(args.image_dir, "*"))):
        try:
            img = read_image(imp)
        except (OSError, ValueError):
            continue  # not an image file the readers decode
        msk = None
        if args.mask_dir:
            msk = read_mask(os.path.join(args.mask_dir,
                                         os.path.basename(imp)))
        pd = cur.patch_and_hash(img, msk, args.crop_size, args.hash_size)
        keep = cur.deduplicate_hashes(pd["hashes"], args.min_distance)
        stem = ".".join(os.path.basename(imp).split(".")[:-1])
        out = {
            "names": [f"{stem}-LOC-2d-{pd['locs'][i]}" for i in keep],
            "patches": [pd["patches"][i] for i in keep],
            "patch_masks": [pd["patch_masks"][i] for i in keep]
            if pd["patch_masks"] else [],
        }
        cur.organize_patches({os.path.basename(imp): out}, args.save_dir)
        print(f"{imp}: kept {len(keep)}/{len(pd['hashes'])} patches")


def main(argv=None):
    args = parse_args(argv)
    from empanada_torch.data import curation as cur

    if args.cmd == "dedup":
        _dedup(args)
    elif args.cmd == "flipbooks":
        from empanada_torch.data.zarr_store import read_volume

        vol = np.asarray(read_volume(args.volume))
        with open(args.locations) as fh:
            locs = json.load(fh)
        books = cur.flipbooks_from_locations(vol, locs, args.span,
                                             args.size)
        np.save(args.save_path, books)
        print(f"{len(books)} flipbooks -> {args.save_path}")
    elif args.cmd == "split-stack":
        with open(args.attributes) as fh:
            attrs = json.load(fh)
        written = cur.split_proof_stack(
            np.load(args.image_stack), np.load(args.mask_stack), attrs,
            args.save_dir, ignore=set(args.ignore))
        print(f"wrote {len(written)} proofread images")
    elif args.cmd == "merge-batch":
        touched = cur.merge_annotation_batch(args.src_dir, args.dst_dir,
                                             args.mask_dirname)
        print(f"merged into datasets: {', '.join(touched)}")
    elif args.cmd == "group-dirs":
        with open(args.conversion) as fh:
            converter = json.load(fh)
        cur.group_annotation_dirs(args.src_dir, converter)
        print("regrouped")


if __name__ == "__main__":
    main()
