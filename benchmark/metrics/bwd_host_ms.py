"""bwd_host_ms.<cell kind> (layer: train step): host ms a step in the
program's ``backward`` phase (its step records; the caller blocks there
for the whole backward), median over the untraced window's steps."""

from harness import spans


def read(run):
    return spans.host_ms(run, "backward")
