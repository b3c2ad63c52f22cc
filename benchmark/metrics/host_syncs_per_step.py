"""host_syncs_per_step: synchronizing CUDA calls per window step on rank 0,
counted by torch.cuda.set_sync_debug_mode("warn") (trace.SyncCounter)
over the --trace 1 run's window: the host waits for the device at each."""


def read(rec):
    if rec.get("syncs") is None or not rec["steps"]:
        return None
    return rec["syncs"] / rec["steps"]
