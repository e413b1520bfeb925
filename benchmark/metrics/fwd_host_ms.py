"""fwd_host_ms.<cell kind> (layer: train step): host ms a step in the
program's ``forward`` phase (its step records, ``utils/profiling.py``),
median over the untraced window's steps."""

from harness import spans


def read(run):
    return spans.host_ms(run, "forward")
