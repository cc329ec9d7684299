"""The PyTorch/CUDA port's benchmark: one cell of ``BENCHMARK.json`` per run
(``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  See README.md."""
