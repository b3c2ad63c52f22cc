"""idle_share: the share of the traced window in which no operation ran on
the device: 100 (1 - busy / window), busy the union of the device's
kernel and copy intervals in torch.profiler's trace (overlapping streams
count once), averaged over the ranks."""


def read(rec):
    if not rec.get("window_s") or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
