"""A rate over the whole window: the units it finished (``count``: samples,
frames) over its seconds."""


def read(run, spec):
    w = run.window
    return w[spec["count"]] / w["elapsed_s"] if w["elapsed_s"] > 0 and w[spec["count"]] else None
