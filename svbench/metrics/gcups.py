"""gcups: DP cells of every batch completed in the window over the
window's seconds, in 1e9 cells a second. A pair's cells are its query
length times its target length; an MSA merge's, its columns times
columns; an LCS pair's, a's length times b's."""


def read(rec):
    return rec["cells"] / rec["window_s"] / 1e9
