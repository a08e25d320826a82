"""teach.harvest_ms_per_image (device harvest): milliseconds an image of
``harvest_dataset_device``, host clock around the synced call, over the
rounds outside the traced one."""


def read(run):
    recs = run["records"][run["traced_units"]:]
    if not recs:
        return None
    n = run["mix"]["teach_images"]
    return 1e3 * sum(r["harvest_s"] for r in recs) / (len(recs) * n)
