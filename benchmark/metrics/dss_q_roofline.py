"""dss_q_roofline: the DSS merge kernel K3
(compose_tpu_torch/csrc/dss_q.cu, C entry dss_q_f64; K4, dss_q_f32, on
the single-precision route) against the H100's memory roofline.

Bytes, from the shapes of every launch in the traced steps (recorded at
the C entry: nt, nin, nout): each input read once and the output written
once, as chip_smoke.py counts them: w and F (nin), q (nt, nin), the slot
table (nout, 4) int32, out (nt, nout). Both launches of a step count
(the density's, nt 1, and the tracers', nt 40). Time: the device time of
the kernels named dss_q_kernel in torch.profiler's trace of the same
steps. Share: bytes / 3.35 TB/s (the SXM part's HBM3, NVIDIA's data
sheet, at its 700 W limit) over that time, in percent."""

HBM_BYTES_PER_S = 3.35e12
KERNEL = "dss_q_kernel"
ENTRIES = {"dss_q_f64": 8, "dss_q_f32": 4}


def nbytes(item, nt, nin, nout):
    return item * (2 * nin + nt * nin + nt * nout) + 16 * nout


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
