"""teach.train_s.icwt30: ``teach.train_s`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/teach.train_s.py``)."""

from benchmark.harness import reader

read = reader("teach.train_s")
