"""attn_bwd_span_roofline.<cell kind> (layer: attention backward): sum
of each attention backward's least time over the device time launched
inside the program's ``octcube.attn.bwd`` ranges, in %."""

from harness import spans


def read(run):
    return spans.attn_roofline(run, backward=True)
