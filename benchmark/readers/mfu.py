"""The window's model operations at the card's published peaks (the least
time: each dtype's operations over its peak, summed) as a share of the
window's seconds, in %. The operations are the cell's own count
(``flops_in_window``, from ``roofline/``)."""


def read(run, spec):
    flops = run.cell.flops_in_window()
    peaks = run.peaks["flops_per_s"]
    least = sum(v / peaks[k] for k, v in flops.items())
    if least <= 0:
        return None
    return 100.0 * least / run.window["elapsed_s"]
