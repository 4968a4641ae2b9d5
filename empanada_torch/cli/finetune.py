"""``python -m empanada_torch finetune finetune.yaml``: finetune an
exported model descriptor (MODEL.config) on new data and export the
result as ``<model_dir>/<config name>_finetuned.yaml``.

The descriptor's FINETUNE section supplies the dataset class, criterion
and engine; TRAIN sets the schedule and the frozen encoder stages
(``finetune_layer``). Runs on CUDA unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Finetune an exported model")
    parser.add_argument("config", type=str,
                        help="Path to a finetune config yaml")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from empanada_torch.config import load_config
    from empanada_torch.export import export_model, load_exported_model
    from empanada_torch.train import Trainer

    config = load_config(args.config)
    descriptor_path = config["MODEL"]["config"]
    model, desc = load_exported_model(descriptor_path, device="cpu")
    finetune_params = desc.get("FINETUNE", {})

    # an export from a recipe that names no dataset class or criterion
    # stores None for them: the defaults apply
    tcfg = dict(config["TRAIN"])
    tcfg.setdefault("dataset_class", finetune_params.get("dataset_class")
                    or "SingleClassInstanceDataset")
    tcfg.setdefault("dataset_params",
                    finetune_params.get("dataset_params") or {})
    tcfg.setdefault("criterion", finetune_params.get("criterion")
                    or "PanopticLoss")
    tcfg.setdefault("criterion_params",
                    finetune_params.get("criterion_params") or {})
    trainer_config = {
        "DATASET": {
            "class_names": desc.get("class_names", {}),
            "labels": desc["labels"],
            "thing_list": desc["thing_list"],
            "norms": desc["norms"],
        },
        "MODEL": desc["model_config"],
        "TRAIN": tcfg,
        "EVAL": config.get("EVAL", {
            "engine": finetune_params.get("engine")
            or "PanopticDeepLabEngine",
            "engine_params": finetune_params.get("engine_params") or {},
        }),
    }

    trainer = Trainer(trainer_config, device=args.device)
    loader = trainer.build_loader()
    trainer.model.load_state_dict(model.state_dict())
    del model
    print(f"=> loaded exported weights from {descriptor_path}")
    trainer.fit(loader=loader)

    name = os.path.splitext(os.path.basename(args.config))[0]
    model_dir = tcfg.get("model_dir", ".")
    export_model(
        trainer.model.state_dict(), desc["model_config"], model_dir,
        f"{name}_finetuned", norms=desc["norms"],
        padding_factor=desc.get("padding_factor", 128),
        thing_list=desc["thing_list"], labels=desc["labels"],
        class_names=desc.get("class_names"),
        finetune_params=finetune_params)
    print(f"=> exported finetuned model {model_dir}/{name}_finetuned.yaml")


if __name__ == "__main__":
    main()
