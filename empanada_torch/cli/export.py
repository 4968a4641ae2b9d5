"""``python -m empanada_torch export config.yaml checkpoint.pth save_dir``:
turn a training checkpoint into the descriptor (``<name>.yaml`` +
``<name>.pth``) that ``infer3d`` reads. The StableHLO, int8 and
torch-artifact options of the JAX package's command are refused: not
ported yet."""

from __future__ import annotations

import argparse
import os

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a trained empanada_torch model for deployment")
    parser.add_argument("config", type=str, help="Training config yaml")
    parser.add_argument("checkpoint", type=str,
                        help="Training checkpoint (.pth)")
    parser.add_argument("save_dir", type=str)
    parser.add_argument("-name", type=str, default=None,
                        help="Exported model name (default: arch_config)")
    parser.add_argument("-pf", type=int, default=128,
                        help="Padding factor baked into the descriptor")
    parser.add_argument("--stablehlo", action="store_true",
                        help="(not ported yet)")
    parser.add_argument("--quantize", action="store_true",
                        help="(not ported yet)")
    parser.add_argument("--from-torch", action="store_true",
                        dest="from_torch", help="(not ported yet)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, on in (("--stablehlo", args.stablehlo),
                     ("--quantize", args.quantize),
                     ("--from-torch", args.from_torch)):
        if on:
            raise SystemExit(
                f"{flag}: not ported yet in empanada_torch (the float32 "
                ".pth descriptor is the only export)")

    from empanada_torch.config import load_config
    from empanada_torch.export import export_model
    from empanada_torch.train.checkpoint import load_checkpoint

    config = load_config(args.config)
    state, meta = load_checkpoint(args.checkpoint)
    arch = config["MODEL"]["arch"]
    cfg_name = os.path.splitext(os.path.basename(args.config))[0]
    name = args.name or f"{arch}_{cfg_name}"
    tcfg = config.get("TRAIN", {})
    ecfg = config.get("EVAL", {})
    finetune_params = {
        "dataset_class": tcfg.get("dataset_class"),
        "dataset_params": tcfg.get("dataset_params", {}),
        "criterion": tcfg.get("criterion"),
        "criterion_params": tcfg.get("criterion_params", {}),
        "engine": ecfg.get("engine"),
        "engine_params": ecfg.get("engine_params", {}),
    }
    export_model(
        state["model"], config["MODEL"], args.save_dir, name,
        norms=meta.get("norms") or config["DATASET"].get("norms"),
        padding_factor=args.pf,
        thing_list=config["DATASET"]["thing_list"],
        labels=config["DATASET"]["labels"],
        class_names=config["DATASET"].get("class_names"),
        finetune_params=finetune_params, run_id=meta.get("run_id"))
    print(f"Exported {name} -> {args.save_dir}")


if __name__ == "__main__":
    main()
