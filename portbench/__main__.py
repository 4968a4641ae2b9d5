"""``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``portbench.run``)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from portbench.run import main

    raise SystemExit(main(t_start=T_START))
