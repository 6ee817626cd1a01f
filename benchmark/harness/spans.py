"""The program's own spans and counters in a `--trace 1` window, for the
per-layer readers that read them.

The port records spans and counters at its layer boundaries while a torch
profiler records (`vae_posterior_consistency_tpu_torch/utils/tracing`),
stamped with the clock of the profiler's events, so they lie over the
window's host operations and device intervals as they are. This is the only
file of the benchmark that reads them:

- `records(ctx)`: the spans and counter events that lie inside the
  profiler's recorded range (the first host operation's start to the last
  one's end); None where the program has no tracer or recorded nothing
  there (a program older than its tracer);
- `self_ns`: each span's duration less its children's;
- `idle_by_span`: the card's idle time in that range (the complement of
  `Window.busy_intervals`), each part put down to the innermost span open
  at that moment, or to `OUTSIDE`.
"""

from __future__ import annotations

import bisect
import collections
import statistics

#: the label of idle time while no span of the program was open
OUTSIDE = "outside any span"

Records = collections.namedtuple("Records", "spans counts lo hi")


def _program_records():
    """Everything the port's tracer holds, or None for a program without
    one."""
    try:
        from vae_posterior_consistency_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def in_range(recs, lo: int, hi: int) -> Records:
    """The spans and counter events of `recs` that lie inside [lo, hi]."""
    spans, counts = [], []
    for r in recs:
        if hasattr(r, "end_ns"):
            if lo <= r.start_ns and r.end_ns <= hi:
                spans.append(r)
        elif lo <= r.t_ns <= hi:
            counts.append(r)
    return Records(spans, counts, lo, hi)


def records(ctx):
    """The window's `Records` (kept in `ctx` for the next reader), or None
    where the trace or the program's records are empty."""
    if "program_spans" not in ctx:
        win, recs = ctx["window"], _program_records()
        out = None
        if recs and win.host_ops:
            lo = min(a for _, a, _ in win.host_ops)
            hi = max(b for _, _, b in win.host_ops)
            out = in_range(recs, lo, hi)
            if not out.spans:
                out = None
        ctx["program_spans"] = out
    return ctx["program_spans"]


def median_us(ctx, name: str):
    """The median duration of the window's spans `name`, in us; None where
    there is none."""
    recs = records(ctx)
    if recs is None:
        return None
    times = [(s.end_ns - s.start_ns) / 1e3 for s in recs.spans
             if s.name == name]
    return statistics.median(times) if times else None


def per_call(ctx, counter: str, call: str):
    """Counter `counter`'s events inside the window's spans `call` (by the
    root id the tracer records), over the number of those spans; None where
    there is no such span."""
    recs = records(ctx)
    if recs is None:
        return None
    roots = {s.id for s in recs.spans if s.name == call}
    if not roots:
        return None
    return sum(c.n for c in recs.counts
               if c.name == counter and c.root in roots) / len(roots)


def self_ns(spans) -> dict:
    """{span id: its duration less the durations of its children} (the
    spans of one thread nest, so its children do not overlap)."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def _depths(spans) -> dict:
    """{span id: how many of its ancestors are among `spans`}."""
    parent = {s.id: s.parent for s in spans}
    depth = {}
    for s in spans:
        chain, i = [], s.id
        while i in parent and i not in depth:
            chain.append(i)
            i = parent[i]
        d = depth.get(i, -1)
        for j in reversed(chain):
            d += 1
            depth[j] = d
    return depth


def _innermost_segments(spans, lo: int, hi: int):
    """[(start, end, label)] covering [lo, hi] in order: the name of the
    deepest span open in each piece (of those opened last where threads
    tie), or OUTSIDE."""
    depth = _depths(spans)
    events = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                    + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    live = []
    out, t, label = [], lo, OUTSIDE
    for when, starts, i in events:
        if when > t:
            out.append((t, when, label))
            t = when
        if starts:
            live.append(spans[i])
        else:
            live.remove(spans[i])
        label = (max(live, key=lambda s: (depth[s.id], s.start_ns)).name
                 if live else OUTSIDE)
    if hi > t:
        out.append((t, hi, label))
    return out


def idle_gaps(win, lo: int, hi: int):
    """The card's idle intervals inside [lo, hi]: the complement there of
    the union of its device operations."""
    out, t = [], lo
    for a, b in win.busy_intervals():
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_span(win, recs: Records) -> collections.Counter:
    """{label: idle ns}: each part of each idle interval of the card inside
    the recorded range, put down to the innermost span open then (its
    name), or to OUTSIDE. The parts sum to the idle time."""
    segs = _innermost_segments(recs.spans, recs.lo, recs.hi)
    starts = [a for a, _, _ in segs]
    by = collections.Counter()
    for a, b in idle_gaps(win, recs.lo, recs.hi):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, label = segs[i]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                by[label] += part
            i += 1
    return by


def idle_share_pct(ctx, *prefixes):
    """The share of the card's idle time in the window whose innermost span
    is named by one of `prefixes` (a name that starts with one), in
    percent; None without such spans, without device operations in the
    trace or without idle time."""
    recs = records(ctx)
    if recs is None or not ctx["window"].device_ops or not any(
            s.name.startswith(prefixes) for s in recs.spans):
        return None
    if "program_idle" not in ctx:
        ctx["program_idle"] = idle_by_span(ctx["window"], recs)
    by = ctx["program_idle"]
    total = sum(by.values())
    if not total:
        return None
    return 100.0 * sum(ns for label, ns in by.items()
                       if label.startswith(prefixes)) / total
