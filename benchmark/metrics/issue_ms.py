"""issue_ms.<cell kind> (layer: train step): host time from the step call
to its return, no synchronize inside; median over the window's steps."""

from harness import readers


def read(run):
    return readers.span_median_ms(run, "issue")
