"""The benchmark of ``fcvsr_tpu_torch`` on one NVIDIA H100: one cell a run,
``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, the cells in ``BENCHMARK.json`` at the repository's root.
See ``harness.py`` for how a run finds its files."""
