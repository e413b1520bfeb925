"""optimizer_ms.<cell kind> (layer: optimizer): device time a step spends
in the kernels launched inside the harness's range around the
optimizer's update call (profiled stretch)."""

from harness import readers


def read(run):
    return readers.per_step_device_ms(run, "bench.optimizer")
