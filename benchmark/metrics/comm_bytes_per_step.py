"""comm_bytes_per_step: bytes one rank receives per step in the sharded
step's collectives (the halo and DSS point-to-point buffers and the
other ranks' parts of every all-gather), counted by CountingDistComm
(comm.py), the largest over the ranks. ShardedIsl.bytes_per_step models
the point-to-point part; the CPU tests hold the count to it."""


def read(rec):
    if rec.get("comm_bytes") is None or not rec["steps"]:
        return None
    return rec["comm_bytes"] / rec["steps"]
