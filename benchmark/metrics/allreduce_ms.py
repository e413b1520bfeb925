"""allreduce_ms.<cell kind> (layer: collectives): device ms a profiled
step of the events launched inside the program's
``octcube.<engine>.reduce`` ranges (the gradient mean over the ranks in
flat buckets and the losses' all-reduce, inside ``update``), on rank 0."""

from harness import spans


def read(run):
    return spans.device_ms(run, "reduce")
