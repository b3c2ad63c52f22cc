"""The benchmark of compose_tpu_torch, the PyTorch and CUDA port: ISL
tracer transport on one or four NVIDIA H100 cards.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by the name that
BENCHMARK.json gives it: configs/<config>.json, traffic/<traffic>.json,
limits/<workload>.json and metrics/<metric>.py. The plain reference that
decides `correct` is reference.py; it imports nothing of the port.
"""
