"""setup_s: from the start of the run's process (the first line of
svbench/run.py) to the first timed batch: imports, card start, the
inputs made and staged, every shape warmed (and the kernels built, in
a checkout's first run)."""


def read(rec):
    return rec["setup_s"]
