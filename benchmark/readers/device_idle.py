"""The device's idle share of the traced window: 100 x (1 - the union of
its operation intervals / the window's seconds), from torch.profiler."""


def read(run, spec):
    if not run.trace or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window["traced_s"])
