"""Command-line tools of the port: the regression battery runner, the QLT
perf test and the step profiler (run each with `python -m
compose_tpu_torch.tools.<name> --help`)."""
