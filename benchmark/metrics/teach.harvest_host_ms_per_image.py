"""teach.harvest_host_ms_per_image (device harvest): milliseconds an image
of the harvest's host stages in the traced round, from the program's spans
under ``odtpu::harvest``: ``harvest.load`` (each canvas's loading, box
scaling and anchor visibility, and with the segmenter ``harvest.masks``,
the masks' projection) plus ``harvest.upload`` (the stacks and copies to
the card), over the round's images."""

from benchmark.spans import traced_root

HOST = ("harvest.load", "harvest.upload")


def read(run):
    ns = sum(r.end_ns - r.start_ns for r in traced_root(run, "harvest") if r.name in HOST)
    if ns <= 0:
        return None
    return ns / 1e6 / run["mix"]["teach_images"]
