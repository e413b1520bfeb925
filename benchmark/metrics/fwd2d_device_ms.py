"""fwd2d_device_ms.<cell kind> (layer: train step): device ms a profiled
step of the events launched inside the program's
``octcube.<engine>.branch2d`` ranges (each 2D forward of a joint step,
inside ``forward``)."""

from harness import spans


def read(run):
    return spans.device_ms(run, "branch2d")
