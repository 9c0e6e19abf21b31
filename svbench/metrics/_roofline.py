"""A kernel's share of its roofline from a run's record."""


def share(rec, key: str):
    bound = rec["work"].get(key)
    spent = rec["trace"].get("kernel_s", {}).get(key) if rec["trace"] \
        else None
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
