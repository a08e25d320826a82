"""full_train.nms_sweeps_per_step (SGD step): the proposals' NMS fixpoint
sweeps of the traced round (the program's counter ``nms.sweeps``, each
sweep one host read), over its steps (its ``sgd.forward`` spans), under
``odtpu::sgd``."""

from benchmark.spans import traced_root


def read(run):
    spans = traced_root(run, "sgd")
    steps = sum(1 for r in spans if r.name == "sgd.forward")
    if not steps:
        return None
    return sum(r.counts.get("nms.sweeps", 0) for r in spans) / steps
