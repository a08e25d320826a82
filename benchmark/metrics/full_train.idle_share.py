"""full_train.idle_share: ``teach.idle_share`` (the share of the traced
window in which no operation ran on the card) read in the cell
``ycbv_full_train.step``; the same reader."""

from benchmark.harness import reader

read = reader("teach.idle_share")
