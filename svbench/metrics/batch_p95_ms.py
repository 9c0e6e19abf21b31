"""batch_p95_ms: the 95th percentile over every batch of the window of
the time from the call that enqueues the batch to its outputs readable
on the host (numpy's linear interpolation)."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["latencies_s"], 95)) * 1e3
