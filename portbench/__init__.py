"""The benchmark of ``empanada_torch`` on an NVIDIA H100.

One command runs one cell of ``BENCHMARK.json``:
``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (``portbench.run``). Everything that measures lives
here and is not edited by changes that claim a gain: the traffic
generators (``gen``), the seeded weights (``weights``), the plain
reference of each configuration (``reference/``), the comparison that
decides ``correct`` (``check``), the operation counts (``flops``), the
table of peaks (``peaks``), the trace reduction (``trace``) and one
reader per per-layer metric (``metrics/``).
"""
