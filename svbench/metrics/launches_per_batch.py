"""launches_per_batch: kernel launches that the port's dispatch counters
(parallel/dispatch.py snapshot()) count over the window, per batch."""

KERNELS = ("myers", "gotoh", "gotoh_tb", "gotoh_banded", "gotoh_banded_tb",
           "lcs", "gotoh_wide", "gotoh_wide_tb")


def read(rec):
    if not rec["batches"]:
        return None
    n = sum(rec["launches"].get(k, 0) for k in KERNELS)
    return n / rec["batches"]
