"""attn_bwd_roofline.<cell kind> (layer: attention backward): sum of each
attention backward's least time over the device time under the attention
op's backward ranges, in %."""

from harness import readers


def read(run):
    return readers.attn_roofline(run, backward=True)
