"""The benchmark of hvq_tpu_torch: cells, traffic, the plain reference and
the metric readers. ``python3 hvq_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; see README.md."""
