"""teach.idle_share.icwt30: ``teach.idle_share`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/teach.idle_share.py``)."""

from benchmark.harness import reader

read = reader("teach.idle_share")
