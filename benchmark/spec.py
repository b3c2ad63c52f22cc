"""Finding a cell's files by the names BENCHMARK.json gives them."""

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(pathlib.Path(root) / "BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, name, bench=None):
        bench = benchmark() if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = _json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(HERE / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")["limits"]

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def metric_reader(name):
    """The `read(rec)` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
