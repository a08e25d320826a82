"""teach.train_s (device training): seconds of ``train_online_modules_device``
a round, the sum of its own synced ``timings=`` stages, over the rounds
outside the traced one."""


def read(run):
    recs = run["records"][run["traced_units"]:]
    if not recs:
        return None
    return sum(r["train_s"] for r in recs) / len(recs)
