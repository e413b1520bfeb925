"""graph_replay_share.<cell kind> (layer: train step): the share of the
untraced window's steps that replayed a captured CUDA graph, from the
``path`` of the program's step records (``utils/profiling.py``), in %.
A program whose records carry no ``path`` reads None."""

from harness import spans


def read(run):
    recs = spans.window_records(run)
    if not recs or not all("path" in r for r in recs):
        return None
    return 100 * sum(r["path"] == "replay" for r in recs) / len(recs)
