"""The traced run's instruments, all from the benchmark's own files: spans
around the calls into each layer (a host clock and a profiler label), a
recorder of the CUDA kernels' launch shapes, a count of host syncs, and
the reduction of a torch.profiler trace to device busy time, launches,
per-kernel device time and the breakdown of the result line."""

import bisect
import collections
import time
import warnings

import torch

# The labels of the spans; the profiler sees them as record_function
# ranges, which name what the host was doing in an idle gap.
SPANS = ("departure", "interp", "rho_cdr", "tracer_cdr", "dss")


class Spans:
    """Host seconds spent in wrapped calls, per span name. Wrapping sets
    an instance attribute, so the program's own calls through `self` go
    through it; nothing of the program is edited."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.on = False

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.seconds[name] += time.perf_counter() - t0
            return out

        setattr(obj, attr, wrapped)


class LaunchRecorder:
    """Records the integer arguments (the shapes) of every launch of the
    port's C kernel entries while `on`, by standing in for the entries of
    `_native.KERNELS`; the launches themselves go to the program's own
    Kernel objects."""

    def __init__(self, native):
        self.native = native
        self.on = False
        self.args = collections.defaultdict(list)
        for name, k in list(native.KERNELS.items()):
            native.KERNELS[name] = self._proxy(name, k)

    def _proxy(self, name, kernel):
        rec = self

        class Proxy:
            launches = property(lambda _: kernel.launches)

            def __call__(self, *args, stream):
                if rec.on:
                    rec.args[name].append(tuple(a for a in args
                                                if isinstance(a, int)))
                return kernel(*args, stream=stream)

        return Proxy()


class SyncCounter:
    """Host syncs counted by torch's sync debug mode while active."""

    def __init__(self, cuda=True):
        self.cuda = cuda
        self.count = 0 if cuda else None
        self.sites = collections.Counter()

    def __enter__(self):
        if not self.cuda:
            return self
        self._w = warnings.catch_warnings(record=True)
        self._log = self._w.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if not self.cuda:
            return
        torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in self._log if "synchroniz" in str(w.message)]
        self.count += len(syncs)
        # Where the host waited: the Python line that made each call.
        self.sites.update(f"{w.filename.split('/')[-1]}:{w.lineno}"
                          for w in syncs)
        self._w.__exit__(*exc)


def union_seconds(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps of the union of `intervals` in [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _short(name, n=80):
    name = name.split("(")[0].replace("void ", "")
    return name[:n]


def reduce_events(events, window_label="bench_window"):
    """Reduce profiler events (dicts of name, device ('cpu' | 'cuda'),
    start, end in microseconds) to the traced window's numbers: window_s,
    busy_s (the union of device intervals inside the window), nccl_s (the
    union of the NCCL kernels' intervals), launches (device operations),
    per-kernel {name: [seconds, count]}, and the breakdown's device_ops and
    idle_gaps (idle seconds by the span the host was in)."""
    win = [e for e in events if e["device"] == "cpu"
           and e["name"] == window_label]
    if not win:
        return None
    lo, hi = win[0]["start"], win[0]["end"]
    dev = [(max(e["start"], lo), min(e["end"], hi), e["name"])
           for e in events if e["device"] == "cuda"
           and e["end"] > lo and e["start"] < hi]
    ivals = [(s, e) for s, e, _ in dev if e > s]
    nccl = [(s, e) for s, e, name in dev if e > s and "nccl" in name.lower()]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += (e - s) * 1e-6
        k[1] += 1
    by_op = collections.defaultdict(float)
    for name, (sec, _) in kernels.items():
        by_op[_short(name)] += sec
    spans = sorted((e["start"], e["end"], e["name"]) for e in events
                   if e["device"] == "cpu" and e["name"] in SPANS)
    starts = [s for s, _, _ in spans]
    idle = collections.defaultdict(float)
    for s, e in gaps(ivals, lo, hi):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        # The innermost span holding the gap's midpoint: spans nest, so
        # the latest-starting one that still covers it.
        where = "between layers"
        while i >= 0:
            if spans[i][1] >= mid:
                where = spans[i][2]
                break
            i -= 1
        idle["host in " + where] += (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) * 1e-6,
                busy_s=union_seconds(ivals) * 1e-6,
                nccl_s=union_seconds(nccl) * 1e-6,
                launches=len(dev), kernels=dict(kernels),
                breakdown=dict(device_ops=[[k, v] for k, v in top],
                               idle_gaps=[[k, v] for k, v in top_gaps]))


def profiler_events(prof):
    """The profiler's events as plain dicts (name, device, start, end in
    microseconds)."""
    out = []
    labels = set(SPANS) | {"bench_window"}
    for e in prof.events():
        dev = "cuda" if e.device_type == torch.autograd.DeviceType.CUDA \
            else "cpu"
        # A record_function range shows on the device's timeline too, as a
        # user annotation spanning its kernels: not an operation.
        if dev == "cuda" and (getattr(e, "is_user_annotation", False)
                              or e.name in labels):
            continue
        out.append(dict(name=e.name, device=dev, start=e.time_range.start,
                        end=e.time_range.end))
    return out
