"""wrapper_host_ms: host milliseconds a batch spends inside the port's
wrappers (ops/myers_cuda.py, ops/lcs_cuda.py, ops/gotoh_cuda.py), each
call timed by svbench's host clock up to its return (no wait for the
card), averaged over the window's batches."""


def read(rec):
    if not rec["batches"]:
        return None
    return rec["wrapper_s"] / rec["batches"] * 1e3
