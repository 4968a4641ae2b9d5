"""``python -m empanada_torch evaluate3d model.yaml volume gt.json``:
run 3D inference (``run_inference3d``) with an exported model on a
volume, write the class's consensus as ``pred_class<id>.json`` and score
it against a ground-truth tracker JSON with ``default_evaluator``.
Runs on CUDA unless ``--device`` names another device. Where the
descriptor names a training run (``run_id``), the scores are logged
back to it."""

from __future__ import annotations

import argparse
import os

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run 3D inference + RLE evaluation vs GT JSON")
    parser.add_argument("config", type=str,
                        help="Exported model descriptor yaml")
    parser.add_argument("volume_path", type=str)
    parser.add_argument("gt_json", type=str,
                        help="Ground-truth tracker JSON")
    parser.add_argument("-out-dir", type=str, default=None)
    parser.add_argument("-class-id", type=int, default=1)
    parser.add_argument("-mode", type=str, default="orthoplane",
                        choices=["orthoplane", "stack"])
    parser.add_argument("-qlen", type=int, default=3)
    parser.add_argument("-nmax", type=int, dest="label_divisor",
                        default=20000)
    parser.add_argument("-seg-thr", type=float, default=0.3)
    parser.add_argument("-nms-thr", type=float, default=0.1)
    parser.add_argument("-nms-kernel", type=int, default=3)
    parser.add_argument("-min-size", type=int, default=500)
    parser.add_argument("-min-span", type=int, default=4)
    parser.add_argument("-pixel-vote-thr", type=int, default=2)
    parser.add_argument("-cluster-iou-thr", type=float, default=0.75)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.data.zarr_store import read_volume
    from empanada_torch.evaluation.evaluator import default_evaluator
    from empanada_torch.export import load_exported_model

    model, desc = load_exported_model(args.config, device=args.device)
    volume = read_volume(args.volume_path)

    consensus = run_inference3d(
        model, volume,
        labels=desc["labels"], thing_list=desc["thing_list"],
        mode=args.mode, qlen=args.qlen, label_divisor=args.label_divisor,
        seg_thr=args.seg_thr, nms_thr=args.nms_thr,
        nms_kernel=args.nms_kernel, min_size=args.min_size,
        min_span=args.min_span, pixel_vote_thr=args.pixel_vote_thr,
        cluster_iou_thr=args.cluster_iou_thr,
        padding_factor=desc.get("padding_factor", 128),
        norms=desc.get("norms"), device=args.device,
    )

    out_dir = args.out_dir or os.path.dirname(args.volume_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    pred_json = os.path.join(out_dir, f"pred_class{args.class_id}.json")
    consensus[args.class_id].write_to_json(pred_json)

    results = default_evaluator()(args.gt_json, pred_json)
    for name, value in results.items():
        print(f"{name}: {float(value):.4f}")

    # log the scores back to the model's training run
    if desc.get("run_id"):
        from empanada_torch.utils.logging import ExperimentLogger

        logger = ExperimentLogger(run_id=desc["run_id"])
        logger.log_metrics({f"eval3d_{k}": float(v)
                            for k, v in results.items()})
        logger.end()
    return results


if __name__ == "__main__":
    main()
