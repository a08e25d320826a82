"""full_train.batch_staged_share (SGD step): the share of the traced round's
steps whose host batch came staged from the trainer's worker thread, built
while the card ran the step before, in %: 100 x the program's counter
``sgd.batch_staged`` over the ``sgd.batch`` spans under ``odtpu::sgd``. A
program that stages nothing (no counter) reads 0."""

from benchmark.spans import traced_root


def read(run):
    spans = traced_root(run, "sgd")
    batches = [r for r in spans if r.name == "sgd.batch"]
    if not batches:
        return None
    return 100.0 * sum(r.counts.get("sgd.batch_staged", 0) for r in batches) / len(batches)
