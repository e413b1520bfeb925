"""graph_pool_gib.<cell kind> (layer: train step): the bytes that the
private memory pool of the process's last captured step graph reserves,
which ``max_memory_allocated`` does not count while the graph replays;
read at the capture (its step record's ``pool_bytes``,
``utils/profiling.py``), in GiB.  None where no step was captured."""

from harness import spans


def read(run):
    pools = [r["pool_bytes"] for r in spans._records() if "pool_bytes" in r]
    return pools[-1] / 2 ** 30 if pools else None
