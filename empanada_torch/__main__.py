"""`python -m empanada_torch <command> [...]` — unified CLI dispatcher."""

import sys

COMMANDS = {
    "infer3d": "empanada_torch.cli.infer3d",
    "train": "empanada_torch.cli.train",
    "finetune": "empanada_torch.cli.finetune",
    "export": "empanada_torch.cli.export",
    "evaluate3d": "empanada_torch.cli.evaluate3d",
    "evaluate3d_bc": "empanada_torch.cli.evaluate3d_bc",
    "curate": "empanada_torch.cli.curate",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help") \
            or sys.argv[1] not in COMMANDS:
        print("usage: python -m empanada_torch "
              f"{{{','.join(COMMANDS)}}} [args...]")
        raise SystemExit(0 if len(sys.argv) >= 2
                         and sys.argv[1] in ("-h", "--help") else 2)
    import importlib

    mod = importlib.import_module(COMMANDS[sys.argv[1]])
    mod.main(sys.argv[2:])


if __name__ == "__main__":
    main()
