"""The program's own spans and counters, on the host's clock and, while a
torch.profiler is active, on the profiler's.

    from compose_tpu_torch import trace
    trace.enable()
    with trace.span("isl.step"):
        ...
    trace.count("qp.newton_iters")
    trace.summary()      # per span name: count, seconds, self seconds, bytes
    trace.disable()

Off by default. While off, `span()` returns one shared no-op context and
`count()` returns at once: a test of the module-level flag `active`, no
allocation and no torch call. While on, a span writes its record (name,
parent, step, start and end on `time.perf_counter_ns`, received bytes)
into preallocated flat arrays; the parent comes from a per-thread stack,
since LocalComm runs one shard per thread, and the step id from the root
span of that stack. A span makes no torch call unless the profiler was
active when its root span opened: then every span of that tree also opens
a `record_function` range of its own name, beside the kernels it
launches, and the first such root records the anchor `ANCHOR`, one
range read on both clocks (`profiler_offset_us`). Under the profiler a
record's interval holds its range's: the host clock is read outside
`record_function`'s enter and exit.

Call `reset()` and `summary()` between steps, with no span open.
"""

import itertools
import threading
import time
from array import array

ANCHOR = "trace.anchor"

active = False

_CAP = 1 << 15


class _Noop:
    """The context `span()` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, nbytes):
        pass


NOOP = _Noop()


class _Store:
    """Flat record arrays, grown by doubling when full."""

    def __init__(self, cap=_CAP):
        self.lock = threading.Lock()
        self.names = []
        self.ids = {}
        self.counters = {}
        self.anchor_ns = None
        self.prof_seen = False
        self.cap = 0
        self.name = array("i")
        self.parent = array("q")
        self.step = array("q")
        self.t0 = array("q")
        self.t1 = array("q")
        self.nbytes = array("q")
        self._grow(cap)
        self.next = itertools.count()
        self.steps = itertools.count()

    def _grow(self, cap):
        for a in (self.name, self.parent, self.step, self.t0, self.t1,
                  self.nbytes):
            a.extend(itertools.repeat(0, cap - self.cap))
        self.cap = cap

    def slot(self):
        i = next(self.next)
        if i >= self.cap:
            with self.lock:
                while i >= self.cap:
                    self._grow(2 * self.cap)
        return i

    def name_id(self, name):
        k = self.ids.get(name)
        if k is None:
            with self.lock:
                k = self.ids.setdefault(name, len(self.names))
                if k == len(self.names):
                    self.names.append(name)
        return k

    def used(self):
        """The number of records written (the next free slot)."""
        n = next(self.next)
        self.next = itertools.count(n)
        return min(n, self.cap)


_store = None
_tls = threading.local()


class _Frame:
    """One thread's open spans: the stack of their record slots, and
    their profiler ranges when the root opened under the profiler. `span()`
    returns it after setting the pending name; `with` opens and closes."""

    def __init__(self):
        self.stack = []
        self.ranges = []
        self.prof = False
        self.step = 0
        self.name = None

    def __enter__(self):
        st = _store
        i = st.slot()
        stack = self.stack
        if stack:
            st.parent[i] = stack[-1]
        else:
            st.parent[i] = -1
            self.step = next(st.steps)
            self.prof = _profiler_active()
            if self.prof and not st.prof_seen:
                _record_anchor(st)
            st.prof_seen = self.prof
        st.name[i] = st.name_id(self.name)
        st.step[i] = self.step
        st.nbytes[i] = 0
        st.t1[i] = 0
        stack.append(i)
        st.t0[i] = time.perf_counter_ns()
        if self.prof:
            from torch.autograd.profiler import record_function
            rf = record_function(self.name)
            rf.__enter__()
            self.ranges.append(rf)
        return self

    def __exit__(self, *exc):
        if self.prof:
            self.ranges.pop().__exit__(None, None, None)
        _store.t1[self.stack.pop()] = time.perf_counter_ns()
        return False

    def add(self, nbytes):
        """Add received bytes to the innermost open span."""
        _store.nbytes[self.stack[-1]] += nbytes


def _profiler_active():
    import torch
    return torch.autograd._profiler_enabled()


def _record_anchor(st):
    """Two empty ranges named ANCHOR, each between two host clock reads;
    the second's reads, the first having paid for any first use."""
    from torch.autograd.profiler import record_function
    for _ in range(2):
        t0 = time.perf_counter_ns()
        with record_function(ANCHOR):
            pass
        st.anchor_ns = (t0, time.perf_counter_ns())


def _frame():
    try:
        return _tls.frame
    except AttributeError:
        _tls.frame = f = _Frame()
        return f


def span(name):
    """A context that records `name` from entry to exit (received bytes
    with `.add(n)` inside it); the shared no-op while off."""
    if not active:
        return NOOP
    f = _frame()
    f.name = name
    return f


def count(name, n=1):
    """Add `n` to the counter `name` (nothing while off)."""
    if not active:
        return
    c = _store.counters
    c[name] = c.get(name, 0) + n


def enable():
    """Turn tracing on; the first call allocates the record arrays."""
    global active, _store
    if _store is None:
        _store = _Store()
    active = True


def disable():
    """Turn tracing off; the records stay until `reset()`."""
    global active
    active = False


def reset():
    """Clear every record, counter and the anchor."""
    global _store
    if _store is not None:
        _store = _Store(_store.cap)


def records():
    """The closed spans in the order they opened: dicts of name, parent
    (an index into this list, or -1), step, start_ns, end_ns, nbytes."""
    st = _store
    if st is None:
        return []
    out, index = [], {}
    for i in range(st.used()):
        if st.t1[i] == 0:
            continue
        index[i] = len(out)
        p = st.parent[i]
        out.append(dict(name=st.names[st.name[i]],
                        parent=index.get(p, -1) if p >= 0 else -1,
                        step=st.step[i], start_ns=st.t0[i],
                        end_ns=st.t1[i], nbytes=st.nbytes[i]))
    return out


def summary():
    """{"spans": {name: {count, s, self_s, bytes}}, "counters": {...}}:
    per span name the closed spans' count, inclusive seconds, self seconds
    (inclusive less the time its children cover) and received bytes."""
    st = _store
    if st is None:
        return {"spans": {}, "counters": {}}
    n = st.used()
    child = [0] * n
    for i in range(n):
        p = st.parent[i]
        if st.t1[i] and p >= 0:
            child[p] += st.t1[i] - st.t0[i]
    spans = {}
    for i in range(n):
        if st.t1[i] == 0:
            continue
        d = spans.setdefault(st.names[st.name[i]],
                             {"count": 0, "s": 0.0, "self_s": 0.0,
                              "bytes": 0})
        dt = st.t1[i] - st.t0[i]
        d["count"] += 1
        d["s"] += dt * 1e-9
        d["self_s"] += (dt - child[i]) * 1e-9
        d["bytes"] += st.nbytes[i]
    return {"spans": spans, "counters": dict(st.counters)}


def step_table(summ=None, root="isl.step"):
    """Lines of a per-step table of `summ` (default: `summary()`): each
    span's inclusive and self seconds per `root` span and its share of
    `root`, then each counter per step, then "full step" (`root`). No
    lines without a `root` span."""
    summ = summary() if summ is None else summ
    spans = summ["spans"]
    top = spans.get(root)
    if not top or not top["count"]:
        return []
    n, tot = top["count"], top["s"]
    out = [f"{name:<26s} {d['s'] / n:9.3e} s/step "
           f"{100 * d['s'] / tot:5.1f}% self {d['self_s'] / n:9.3e}"
           for name, d in sorted(spans.items()) if name != root]
    out += [f"{name:<26s} {v / n:9.3f} /step"
            for name, v in sorted(summ["counters"].items())]
    out.append(f"{'full step':<26s} {tot / n:9.3e} s/step {100.0:5.1f}%")
    return out


def recv_bytes(comm, x, perm):
    """Bytes this rank receives in `comm.ppermute(x, perm)`: x's size once
    per source that sends to it (a `comm.*` span's count)."""
    nsrc = sum(1 for _, d in perm if d == comm.rank)
    return nsrc * x.numel() * x.element_size()


def gather_bytes(comm, x):
    """Bytes this rank receives in `comm.all_gather(x)`: the other ranks'
    parts."""
    return (comm.size - 1) * x.numel() * x.element_size()


def profiler_offset_us(events):
    """Microseconds to add to `ns / 1e3` of a record to put it on the
    profiler's clock: from the last anchor range among `events` (objects
    with `.name` and `.time_range` in us, as `prof.events()` gives them),
    the mean of its start's and its end's offsets from the host clock
    reads around it. None without an anchor or its range."""
    st = _store
    if st is None or st.anchor_ns is None:
        return None
    ranges = [e.time_range for e in events if e.name == ANCHOR]
    if not ranges:
        return None
    r = max(ranges, key=lambda r: r.start)
    t0, t1 = st.anchor_ns
    return 0.5 * ((r.start - t0 / 1e3) + (r.end - t1 / 1e3))
