"""fwd_device_ms.<cell kind> (layer: train step): device ms a profiled
step of the events launched inside the program's
``octcube.<engine>.forward`` ranges."""

from harness import spans


def read(run):
    return spans.device_ms(run, "forward")
