"""limit_caas_roofline: the cell-local CAAS limiter kernel K2
(compose_tpu_torch/csrc/limit_caas.cu, C entries limit_caas_f64 and
limit_caas_f32) against the H100's memory roofline.

Bytes, from the shapes of every launch in the traced steps (recorded at
the C entry: nt, ncell, np2): each input read once and the output
written once, as chip_smoke.py counts them: rhom and rho (ncell, np2),
Q, qmin and qmax (nt, ncell, np2), b (nt, ncell), out (nt, ncell, np2).
Time: the device time of the kernels named limit_caas_kernel in
torch.profiler's trace of the same steps. Share: bytes / 3.35 TB/s (the
SXM part's HBM3, NVIDIA's data sheet, at its 700 W limit) over that
time, in percent."""

HBM_BYTES_PER_S = 3.35e12
KERNEL = "limit_caas_kernel"
ENTRIES = {"limit_caas_f64": 8, "limit_caas_f32": 4}


def nbytes(item, nt, ncell, np2):
    return item * (2 * ncell * np2 + 4 * nt * ncell * np2 + nt * ncell)


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    total = sum(nbytes(item, *a[-3:]) for e, item in ENTRIES.items()
                for a in t["launch_args"].get(e, []))
    sec = sum(s for name, (s, _) in t["kernels"].items() if KERNEL in name)
    if not total or not sec:
        return None
    return 100.0 * total / HBM_BYTES_PER_S / sec
