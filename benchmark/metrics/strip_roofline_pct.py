"""The tile kernel (``csrc/spmm_strip.cu``): the least time its work allows
at 3.35 TB/s over the device time of ``strip_kernel``, summed over the
traced epochs' launches. The work of a launch is counted from the graph
as run (``counts.gather_bytes``): each tile edge's column index, each
distinct source row the tile edges read at the launch's width and element
size, and each output row written, once."""
from benchmark.counts import gather_bytes, roofline_pct
from benchmark.trace import device_us_named


def read(record):
    nbytes = us = 0.0
    for r in record["ranks"]:
        tr = r.get("trace")
        if not tr:
            continue
        us += device_us_named(tr, "strip_kernel")
        nbytes += sum(gather_bytes(lay["edges"], lay["src_rows"], lay["out_rows"], width, elt)
                      for lay, width, elt in tr["strip_calls"])
    if us <= 0 or nbytes <= 0:
        return None
    return roofline_pct(nbytes, us * 1e-6)
