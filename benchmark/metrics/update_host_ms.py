"""update_host_ms.<cell kind> (layer: train step): host ms a step in the
program's ``update`` phase (the gradient reduction where there is one,
the norm, AdamW; its step records), median over the untraced window's
steps."""

from harness import spans


def read(run):
    return spans.host_ms(run, "update")
