"""teach.nms_sweeps_per_batch (device harvest): the NMS fixpoint sweeps of
the traced round (the program's counter ``nms.sweeps``, each sweep one host
read), over its canvas batches (its ``harvest.trunk`` spans), under
``odtpu::harvest``."""

from benchmark.spans import traced_root


def read(run):
    spans = traced_root(run, "harvest")
    batches = sum(1 for r in spans if r.name == "harvest.trunk")
    if not batches:
        return None
    return sum(r.counts.get("nms.sweeps", 0) for r in spans) / batches
