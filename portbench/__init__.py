"""The benchmark of careless_tpu_torch, the PyTorch and CUDA port, on one
NVIDIA card: full-batch merge steps per second, peak memory and set-up
time, with per-layer metrics from the profiler's trace.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

BENCHMARK.json at the root of the checkout names the cells. A cell pairs a
configuration (configs/<name>.json: the CLI's flags) with a traffic mix
(traffic/<name>.json: the sizes of the seeded problem); workloads/<cell>.json
holds the limits of the comparison that decides `correct`, and
metrics/<name>.py the reader of each per-layer metric. A cell, a
configuration, a traffic mix or a metric is added by adding its files and
its entry in BENCHMARK.json. Nothing here imports the JAX package or JAX.
"""
