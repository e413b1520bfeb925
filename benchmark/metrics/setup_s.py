"""setup_s: seconds from process start to the first timed step or request
(host clock)."""


def read(run):
    return run.setup_s
