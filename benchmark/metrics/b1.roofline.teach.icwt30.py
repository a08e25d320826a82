"""b1.roofline.teach.icwt30: ``b1.roofline.teach`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/b1.roofline.teach.py``)."""

from benchmark.harness import reader

read = reader("b1.roofline.teach")
