"""full_train.host_ms_per_step (SGD step): milliseconds a step of the SGD
step's host stages in the traced round, from the program's spans under
``odtpu::sgd``: ``sgd.batch`` (``host_batch``: the canvas, the scaled GT and
each GT mask resized to the canvas, in numpy) plus ``sgd.upload`` (the
copies to the card, the GT masks and the draws), over the round's steps."""

from benchmark.spans import traced_root

HOST = ("sgd.batch", "sgd.upload")


def read(run):
    spans = traced_root(run, "sgd")
    steps = sum(1 for r in spans if r.name == "sgd.batch")
    if not steps:
        return None
    return sum(r.end_ns - r.start_ns for r in spans if r.name in HOST) / 1e6 / steps
