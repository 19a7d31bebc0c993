"""Aggregation: device ms an epoch of the operations launched inside the
harness's span around ``dist_aggregate`` (the tile kernel, the ELL tail,
the degree scaling, the exchange's forward at K>1) and inside the backward
nodes of the aggregation's and the exchange's autograd functions; the
largest rank."""
from benchmark.trace import BACKWARD_PREFIX, device_us_owned

BACKWARD_NODES = ("ReverseSpmm", "PairSegSpmm", "Exchange")


def _owned(owners):
    return any(o == "bench.agg" or (o.startswith(BACKWARD_PREFIX)
                                    and any(n in o for n in BACKWARD_NODES))
               for o in owners)


def read(record):
    vals = [device_us_owned(r["trace"], _owned) / r["trace"]["epochs"] * 1e-3
            for r in record["ranks"] if "trace" in r]
    vals = [v for v in vals if v > 0]
    return max(vals) if vals else None
