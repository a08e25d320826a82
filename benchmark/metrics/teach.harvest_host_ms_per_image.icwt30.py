"""teach.harvest_host_ms_per_image.icwt30: ``teach.harvest_host_ms_per_image`` read in the cell ``icwt30.teach``, which reports
``teach_s.icwt30``; the same reader (``metrics/teach.harvest_host_ms_per_image.py``)."""

from benchmark.harness import reader

read = reader("teach.harvest_host_ms_per_image")
