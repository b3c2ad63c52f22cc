"""The host's side of the measured window: the CPU seconds of the
process's busiest threads, read from /proc before and after it. It goes
to standard error; no metric reads it. Where /proc lacks a thread's file
that thread is left out.
"""

import os


def snapshot():
    """{tid: (name, user + system ticks)} of this process's threads."""
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                text = f.read()
        except OSError:
            continue
        name = text[text.index("(") + 1:text.rindex(")")]
        f = text[text.rindex(")") + 2:].split()
        out[int(tid)] = (name, int(f[11]) + int(f[12]))
    return out


def summary(a, b, window_s):
    """The busiest threads' CPU seconds over the window, from two
    snapshots."""
    hz = os.sysconf("SC_CLK_TCK")
    busy = sorted(((b[t][1] - a.get(t, ("", 0))[1]) / hz, b[t][0])
                  for t in b)
    return dict(window_s=window_s, threads=len(b),
                busiest_threads_s=[[n, round(s, 2)]
                                   for s, n in reversed(busy[-3:])])
