"""attn_fwd_roofline.<cell kind> (layer: attention forward): sum of each
attention call's least time over the device time under the attention
op's forward ranges, in %."""

from harness import readers


def read(run):
    return readers.attn_roofline(run, backward=False)
