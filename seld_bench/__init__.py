"""The benchmark of `seld_tpu_torch` on NVIDIA cards.

    python3 -m seld_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name `BENCHMARK.json`
gives it: `configs/<config>.json`, `traffic/<mix>.json` (which names its
driver, `drivers/<kind>.py`), `metrics/<metric>.py` and
`limits/<workload>.json`. `yardstick/` (peaks, work counts, the trace
reduction) and `reference/` (the plain PyTorch models the outputs are
judged against) import nothing of the program.
"""
