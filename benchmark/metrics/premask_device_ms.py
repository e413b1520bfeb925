"""premask_device_ms.<cell kind> (layer: pre-mask): device ms a profiled
step of the events launched inside the program's
``octcube.<engine>.premask`` ranges (the pre-mask's patch embedding,
similarity products and sorts, inside the 3D forward)."""

from harness import spans


def read(run):
    return spans.device_ms(run, "premask")
