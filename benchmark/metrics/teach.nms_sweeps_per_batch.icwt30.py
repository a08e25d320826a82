"""teach.nms_sweeps_per_batch.icwt30: ``teach.nms_sweeps_per_batch`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/teach.nms_sweeps_per_batch.py``)."""

from benchmark.harness import reader

read = reader("teach.nms_sweeps_per_batch")
