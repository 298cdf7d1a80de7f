"""K1's share of its roofline: the least time of every call the span
captured (``roofline/k1.py``, from K1's inputs) over the device time of
K1's kernels in the trace (the records whose names hold
``kernel_match``, plain or mangled), in %."""
import sys

from ..roofline import k1


def read(run, spec):
    span = run.spans.spans.get(spec["span"])
    if span is None or not span.captures or not run.trace:
        return None
    hits = {k: v for k, v in run.trace["kernels"].items() if spec["kernel_match"] in k}
    print(f"K1 kernels in the trace: {len(hits)} names, {sum(hits.values()) * 1e3:.3f} ms; "
          f"calls captured: {len(span.captures)}", file=sys.stderr)
    dev = sum(hits.values())
    if dev <= 0:
        return None
    least = 0.0
    for args, kwargs in span.captures:
        a, b, radius = args[:3]
        least += k1.least_seconds(a, b, float(radius), kwargs.get("b_valid"), run.peaks)
    return 100.0 * least / dev
