"""mfu.<cell kind> (layer: whole step): analytic model FLOPs of the
window's steps over the window, a share of the chips' bf16 peak (989e12
FLOP/s a chip), in %."""

from harness import readers


def read(run):
    return readers.mfu(run)
