"""A span's CUDA-event time over the traced window, per unit (``per``:
calls, frames) of the window: total ms / units."""


def read(run, spec):
    span = run.spans.spans.get(spec["span"])
    units = run.window[spec["per"]]
    if span is None or not span.events or not units:
        return None
    return span.total_ms() / units
