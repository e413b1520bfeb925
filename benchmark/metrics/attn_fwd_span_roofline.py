"""attn_fwd_span_roofline.<cell kind> (layer: attention forward): sum of
each attention call's least time (the shapes the program counts in its
step records) over the device time launched inside the program's
``octcube.attn.fwd`` ranges, in %."""

from harness import spans


def read(run):
    return spans.attn_roofline(run, backward=False)
