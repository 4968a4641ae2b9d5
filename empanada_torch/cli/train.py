"""``python -m empanada_torch train config.yaml [--epochs N]``: train a
model from a recipe.

With no ``--device``, one worker process per visible card joins one
NCCL process group (a local rendezvous when this host is alone) and the
trainer runs data-parallel over them (``TRAIN.batch_size`` is the global
batch); one visible card means one process. ``--device cuda:0`` or
``--device cpu`` keeps one worker on that device. ``--coordinator
host:port --num-processes H --process-id i`` mean hosts, as the JAX
package's command: each of the H hosts runs this command, starts its
workers (one per card, or one on ``--device``), and worker l of host i
is global rank i * workers + l. A CPU worker joins over gloo. Rank 0
logs and writes the checkpoints.

Speed today: data-parallel steps are bound by the host's launches and
the global batch norm's per-layer all-reduces, so on the H100 host
measured so far four cards train the MitoNet recipe at 0.27-0.46x one
card's images/s (PERF.md §5). ``--device cuda:0`` is the faster choice
until that is repaired.
"""

from __future__ import annotations

import argparse
import os
import socket

__all__ = ["main", "parse_args", "plan_workers"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="empanada_torch training")
    parser.add_argument("config", type=str, help="Path to a config yaml")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override TRAIN.schedule_params.epochs")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Rendezvous address host:port of rank 0's "
                             "host (several hosts; default: a free local "
                             "port when this host is alone)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Number of hosts (one command each)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="This host's index in [0, --num-processes)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of this host's one worker "
                             "(default: one worker per visible card; "
                             "'cpu' to run on the CPU). Today one card "
                             "('cuda:0') trains faster than several: "
                             "PERF.md section 5")
    return parser.parse_args(argv)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plan_workers(args, n_cards):
    """The workers this host starts: {"coordinator", "world", "ranks"
    (global rank of each local worker), "device" (None = the worker's
    card), "backend"}. Raises SystemExit on flags that do not fit
    together."""
    hosts = args.num_processes or 1
    host = args.process_id or 0
    if hosts > 1 and args.coordinator is None:
        raise SystemExit("--num-processes > 1 needs --coordinator host:port")
    if not 0 <= host < hosts:
        raise SystemExit(f"--process-id {host} is not in [0, {hosts})")
    local = 1 if args.device is not None else max(n_cards, 1)
    world = hosts * local
    coordinator = args.coordinator
    if coordinator is None and world > 1:
        coordinator = f"127.0.0.1:{_free_port()}"
    on_cpu = args.device is not None and args.device.startswith("cpu")
    return {"coordinator": coordinator, "world": world,
            "ranks": [host * local + i for i in range(local)],
            "device": args.device,
            "backend": "gloo" if on_cpu or n_cards == 0 else "nccl"}


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


def summary(trainer):
    """One line of this rank's run: steps, global images/s and data-wait
    share over the steps after the first (host clock), peak device
    memory on a card."""
    line = trainer.timeline
    text = f"rank {trainer.rank} of {trainer.world}: {len(line)} steps"
    if len(line) > 1:
        seconds = line[-1]["end"] - line[0]["end"]
        wait = sum(t["data_wait"] for t in line[1:])
        text += (f", {(len(line) - 1) * trainer.batch_size / seconds:.2f} "
                 f"images/s after the first step (global batch "
                 f"{trainer.batch_size}), data-wait share "
                 f"{wait / seconds:.4f}")
    if trainer.device.type == "cuda":
        import torch

        gib = torch.cuda.max_memory_allocated(trainer.device) / 2 ** 30
        text += f", peak device memory {gib:.3f} GiB"
    return text


def _worker(local_rank, args, plan):
    """One worker: join the group (world > 1), train, leave."""
    import torch

    from empanada_torch.parallel import initialize_distributed

    rank = plan["ranks"][local_rank]
    device = plan["device"]
    if device is not None and torch.device(device).type == "cuda":
        local_rank = torch.device(device).index or 0  # the named card
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(len(plan["ranks"]))
    initialize_distributed(plan["coordinator"], plan["world"], rank,
                           backend=plan["backend"])
    try:
        from empanada_torch.config import load_config
        from empanada_torch.train import Trainer

        config = load_config(args.config)
        assert config["MODEL"]["arch"], "config must name MODEL.arch"
        logger = make_logger(config) if rank == 0 else None
        trainer = Trainer(config, device=plan["device"])
        trainer.fit(epochs=args.epochs, logger=logger,
                    log_fn=print if rank == 0 else (lambda *a: None))
        print(summary(trainer), flush=True)
        if logger is not None:
            logger.end()
    finally:
        if plan["world"] > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    plan = plan_workers(args, _visible_cards())
    if plan["world"] > 1:
        print(f"training over {plan['world']} ranks ({plan['backend']}), "
              f"this host's: {plan['ranks']}, rendezvous "
              f"{plan['coordinator']}")
    if len(plan["ranks"]) == 1:
        _worker(0, args, plan)
        return
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(args, plan), nprocs=len(plan["ranks"]),
             join=True)


def _visible_cards():
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


if __name__ == "__main__":
    main()
