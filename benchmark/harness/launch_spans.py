"""The card's busy time in a `--trace 1` window, put down to the program
span in which each device operation was launched.

`harness/spans.idle_by_span` puts the card's idle time down to the span
open while it idles; a cell whose card is busy needs its busy time split
too. A kernel runs after the host launched it, often while the host is
already in a later span, so an operation is put down to the span that was
innermost at its launch: the CUDA runtime or driver call
(`cudaLaunchKernel`, `cudaMemcpyAsync`, `cuLaunchKernel`, ...) that the
profiler records on the host with the same correlation id as the device
operation it made.

- `read_launches(win)`: ({correlation id: launch time}, [(correlation id,
  start, end)] of the device operations), read from the window's profiler;
- `busy_by_launch_span(launches, ops, recs)`: {label: device ns}, the
  union of the intervals of the operations launched while that label's
  span was innermost (or `spans.OUTSIDE`); operations without a launch in
  the range are left out;
- `busy_share_pct(ctx, name)`: the share of the card's busy time in the
  window spent in operations launched while span `name` was innermost.
"""

from __future__ import annotations

import bisect
import collections
import re

from harness import spans

#: the host-side names of the runtime and driver calls that start device
#: work (a CPU operator's own correlation ids are another sequence)
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def read_launches(win):
    """({correlation id: launch start ns}, [(correlation id, start ns, end
    ns)] of the device operations) from the window's profiler; empty
    without one."""
    from torch.autograd import DeviceType

    launches, ops = {}, []
    if win.prof is None:
        return launches, ops
    for e in win.prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        if not corr:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((corr, e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU and _LAUNCH.match(e.name()):
            launches[corr] = e.start_ns()
    return launches, ops


def busy_by_launch_span(launches, ops, recs) -> collections.Counter:
    """{label: device ns}: the operations `ops` whose launch lies in the
    records' range, each put down to the innermost span open at its
    launch (`spans.OUTSIDE` for none)."""
    segs = spans._innermost_segments(recs.spans, recs.lo, recs.hi)
    starts = [a for a, _, _ in segs]
    intervals = collections.defaultdict(list)
    for corr, a, b in ops:
        t = launches.get(corr)
        if t is None or not recs.lo <= t < recs.hi:
            continue
        intervals[segs[bisect.bisect_right(starts, t) - 1][2]].append((a, b))
    by = collections.Counter()
    for label, ivs in intervals.items():
        end = None
        for a, b in sorted(ivs):  # the union: overlapping operations once
            if end is not None and a < end:
                a = end
            if b > a:
                by[label] += b - a
            end = b if end is None else max(end, b)
    return by


def busy_share_pct(ctx, name: str):
    """100 x the device time of the operations launched while span `name`
    was innermost, over the card's busy time in the window; None without
    such spans, device operations or matched launches."""
    recs = spans.records(ctx)
    win = ctx["window"]
    if recs is None or not win.device_ops or not any(
            s.name == name for s in recs.spans):
        return None
    if "launch_busy" not in ctx:
        launches, ops = read_launches(win)
        ctx["launch_busy"] = busy_by_launch_span(launches, ops, recs)
    by = ctx["launch_busy"]
    busy_ns = win.busy_s() * 1e9
    if not by or not busy_ns:
        return None
    return 100.0 * by.get(name, 0) / busy_ns
