"""idle_share.<cell kind> (layer: device): 1 - the device's busy time a
step (the union of kernel and copy intervals over the profiled steps)
over the untraced window's time a step, in %.  The profiled steps give
the busy time only: the profiler's own host cost stretches a host-bound
step, so their wall time is not the window's."""

from harness import readers


def read(run):
    return readers.idle_share(run)
