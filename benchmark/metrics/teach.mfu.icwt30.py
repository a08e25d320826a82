"""teach.mfu.icwt30: ``teach.mfu`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/teach.mfu.py``)."""

from benchmark.harness import reader

read = reader("teach.mfu")
