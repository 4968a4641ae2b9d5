"""``python -m empanada_torch export config.yaml checkpoint.pth save_dir``:
turn a training checkpoint into the descriptor (``<name>.yaml`` +
``<name>.pth``) that ``infer3d`` reads. ``--quantize`` also writes the
weight-only int8 artifact (``<name>.int8.pth``), and ``--from-torch``
reads the checkpoint as a reference torch artifact (a plain checkpoint
or a TorchScript archive, such as MitoNet's published ``.pth``) and
converts it into the config's model. ``--stablehlo`` is refused: the
artifact has no counterpart on the GPU."""

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
                        help="(refused: no StableHLO artifact on the GPU)")
    parser.add_argument("--quantize", action="store_true",
                        help="Also write a weight-only int8 artifact "
                             "(the analog of the reference's fbgemm INT8 "
                             "export)")
    parser.add_argument("--from-torch", action="store_true",
                        dest="from_torch",
                        help="checkpoint is a reference torch artifact "
                             "(plain torch.save checkpoint OR a "
                             "TorchScript archive like the reference's "
                             "distributed MitoNet .pth); structurally "
                             "convert it into the config's model")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.stablehlo:
        raise SystemExit("--stablehlo: not ported yet in empanada_torch "
                         "(the StableHLO artifact has no counterpart on "
                         "the GPU)")

    from empanada_torch.config import load_config
    from empanada_torch.export import export_model, import_torch_model
    from empanada_torch.train.checkpoint import load_checkpoint

    config = load_config(args.config)
    arch = config["MODEL"]["arch"]
    cfg_name = os.path.splitext(os.path.basename(args.config))[0]
    name = args.name or f"{arch}_{cfg_name}"
    if args.from_torch:
        desc = import_torch_model(
            args.checkpoint, config["MODEL"], args.save_dir, name,
            norms=config.get("DATASET", {}).get("norms"),
            padding_factor=args.pf,
            thing_list=config["DATASET"]["thing_list"],
            labels=config["DATASET"]["labels"],
            class_names=config["DATASET"].get("class_names"),
            quantize=args.quantize)
        print(f"Imported torch artifact -> {args.save_dir}/{name}.yaml "
              f"({', '.join(k for k in desc if k.startswith('model'))})")
        return

    state, meta = load_checkpoint(args.checkpoint)
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
    desc = export_model(
        state["model"], config["MODEL"], args.save_dir, name,
        norms=meta.get("norms") or config["DATASET"].get("norms"),
        padding_factor=args.pf,
        thing_list=config["DATASET"]["thing_list"],
        labels=config["DATASET"]["labels"],
        class_names=config["DATASET"].get("class_names"),
        finetune_params=finetune_params, quantize=args.quantize,
        run_id=meta.get("run_id"))
    print(f"Exported {name} -> {args.save_dir} "
          f"({', '.join(k for k in desc if k.startswith('model'))})")


if __name__ == "__main__":
    main()
