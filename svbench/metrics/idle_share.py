"""idle_share: the share of the traced window, in %, in which no kernel,
copy or memset ran on the card (the union of their intervals in the
torch.profiler trace). None where the trace holds no device record."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr.get("busy_s", 0.0) <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
