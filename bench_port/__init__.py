"""The port's benchmark: `python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see `harness.py`; the cells are in `BENCHMARK.json` at the checkout's root)."""
