"""Spans around the calls into the program's layers, and the reduction of a
``torch.profiler`` trace to what the per-layer metrics read.

Spans are ``record_function`` ranges opened by the benchmark's own code:
``bench.stretch`` (the traced epochs), ``bench.step`` (one
``Trainer._train_step``), ``bench.assign`` (one ``Trainer._reassign``) and
``bench.agg`` (one ``dist_aggregate``, wrapped where ``model/gnn.py``
calls it). The backward pass runs on autograd's own thread, inside ranges
that autograd names after each node (``autograd::engine::evaluate_function:
<Node>``); those are kept as spans too.

Each device operation is tied to the host call that launched it (the
runtime call with its correlation id) and so to the spans that enclose that
call in time: its ``owners``.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def wrapped(module, name: str, wrapper_of):
    """``module.name`` replaced by ``wrapper_of(original)`` inside the block.
    Attributes of the original (a launch counter) are carried over and
    back."""
    original = getattr(module, name)
    wrapper = wrapper_of(original)
    wrapper.__dict__.update(original.__dict__)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        original.__dict__.update(wrapper.__dict__)
        setattr(module, name, original)


def spanned(span: str):
    """A wrapper maker: the call inside ``record_function(span)``."""
    from torch.profiler import record_function

    def wrapper_of(fn):
        def call(*args, **kwargs):
            with record_function(span):
                return fn(*args, **kwargs)
        return call
    return wrapper_of


def _is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIX) or name.startswith(BACKWARD_PREFIX)


def reduce_profile(prof) -> dict:
    """The traced stretch as plain data:

    - ``window``: (start, end) of the ``bench.stretch`` span, in µs;
    - ``device``: every device operation as (name, start, end, owners),
      ``owners`` the names of the spans around its launch, outermost first;
    - ``host``: the main thread's host operations as (name, start, end), to
      name what the host did while the device idled.

    A device operation whose launch is not in the trace has no owners."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    stretch = [e for e in cpu if e.name == SPAN_PREFIX + "stretch"]
    if not stretch:
        raise RuntimeError("the trace holds no bench.stretch span")
    stretch = stretch[0]
    main = stretch.thread
    # every span, sorted by start: the backward's spans (autograd's thread)
    # never overlap the forward's bench.agg (the main thread waits in
    # backward), so a launch's time alone finds the spans around it
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                   if _is_span(e.name))
    launch: Dict[int, float] = {}
    device = []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # the spans appear on the device's timeline too, as annotations
            if not (_is_span(e.name) or getattr(e, "is_user_annotation", False)):
                device.append(e)
        elif e.device_type == DeviceType.CPU and e.name.startswith("cu"):
            launch.setdefault(e.id, e.time_range.start)  # runtime calls

    def owners(t: float) -> Tuple[str, ...]:
        out = []
        for s, end, name in spans:
            if s > t:
                break
            if end >= t:
                out.append(name)
        return tuple(out)

    dev = []
    for e in device:
        hit = launch.get(e.id)
        dev.append((e.name, e.time_range.start, e.time_range.end,
                    () if hit is None else owners(hit)))
    host = [(e.name, e.time_range.start, e.time_range.end) for e in cpu
            if e.thread == main and not e.name.startswith(SPAN_PREFIX)
            and e.time_range.start >= stretch.time_range.start
            and e.time_range.end <= stretch.time_range.end]
    return {"window": (stretch.time_range.start, stretch.time_range.end), "device": dev,
            "host": host}


def busy_intervals(device, window) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside ``window``."""
    lo, hi = window
    ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in device if e > lo and s < hi)
    out: List[List[float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(tr: dict) -> float:
    return sum(e - s for s, e in busy_intervals(tr["device"], tr["window"]))


def device_ops(tr: dict, top: int = 10) -> List[Tuple[str, float]]:
    """The device operations that took most time, in seconds."""
    total: Dict[str, float] = {}
    for name, s, e, _ in tr["device"]:
        total[name] = total.get(name, 0.0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us * 1e-6] for name, us in ranked]


def idle_gaps(tr: dict, top: int = 10) -> List[Tuple[str, float]]:
    """The longest gaps with nothing on the device, each named by the
    innermost host operation of the main thread at its middle."""
    lo, hi = tr["window"]
    busy = busy_intervals(tr["device"], tr["window"])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        name = "host outside any operation"
        best: Optional[float] = None
        for h in host[:bisect.bisect_right(starts, mid)]:
            if h[2] >= mid and (best is None or h[1] >= best):
                name, best = h[0], h[1]
        out.append([name[:120], (e - s) * 1e-6])
    return out


def device_us_owned(tr: dict, owned) -> float:
    """Device µs of the operations whose owners satisfy ``owned``."""
    return sum(e - s for _, s, e, own in tr["device"] if owned(own))


def device_us_named(tr: dict, part: str) -> float:
    """Device µs of the operations whose name contains ``part``."""
    return sum(e - s for name, s, e, _ in tr["device"] if part in name)
