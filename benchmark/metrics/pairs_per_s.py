"""pairs_per_s: contrastive pairs completed over the whole window per
second of the window (host clock)."""

from harness import readers


def read(run):
    return readers.window_rate(run, "samples")
