"""Device: the share of the traced stretch in which no kernel, copy or set
ran on the card, from the profiler's timeline; the largest rank."""
from benchmark.trace import busy_us


def read(record):
    vals = []
    for r in record["ranks"]:
        tr = r.get("trace")
        if tr and tr["device"]:
            lo, hi = tr["window"]
            vals.append(100.0 * (1.0 - busy_us(tr) / (hi - lo)))
    return max(vals) if vals else None
