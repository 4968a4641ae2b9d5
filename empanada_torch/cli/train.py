"""``python -m empanada_torch train config.yaml [--epochs N]``: train a
model from a recipe on one device (CUDA unless ``--device`` names
another). The multi-process flags of the JAX package's command are
refused: multi-device training is not ported yet."""

from __future__ import annotations

import argparse

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="empanada_torch training")
    parser.add_argument("config", type=str, help="Path to a config yaml")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override TRAIN.schedule_params.epochs")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-host coordinator address host:port "
                             "(not ported yet)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="(not ported yet)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="(not ported yet)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    return parser.parse_args(argv)


def refuse_multiprocess(args):
    for flag, value in (("--coordinator", args.coordinator),
                        ("--num-processes", args.num_processes),
                        ("--process-id", args.process_id)):
        if value is not None:
            raise SystemExit(
                f"{flag}: not ported yet in empanada_torch (multi-process "
                "training comes with the multi-device slice)")


def make_logger(config):
    """The run's ExperimentLogger, or None with TRAIN.logging false."""
    if not config["TRAIN"].get("logging", True):
        return None
    from empanada_torch.utils.logging import ExperimentLogger

    logger = ExperimentLogger(
        experiment=config["DATASET"].get("dataset_name", "Default"),
        run_name=config["TRAIN"].get("run_name"))
    logger.log_params({
        **{f"MODEL.{k}": v for k, v in config["MODEL"].items()},
        **{f"TRAIN.{k}": v for k, v in config["TRAIN"].items()
           if not isinstance(v, (list, dict))},
    })
    return logger


def main(argv=None):
    args = parse_args(argv)
    refuse_multiprocess(args)

    from empanada_torch.config import load_config
    from empanada_torch.train import Trainer

    config = load_config(args.config)
    assert config["MODEL"]["arch"], "config must name MODEL.arch"
    logger = make_logger(config)
    trainer = Trainer(config, device=args.device)
    trainer.fit(epochs=args.epochs, logger=logger)
    if logger is not None:
        logger.end()


if __name__ == "__main__":
    main()
