"""The `--trace 1` window: torch.profiler over the timed loop, and what the
per-layer readers take from it.

- device operations: kernels, copies and fills on the card's timeline
  (not the annotation ranges the profiler also draws there);
- busy time: the union of their intervals (as the port's
  `engine/profile_train.busy_ms` computes it, copied here so that a change
  to the program cannot change the yardstick);
- host operations: the CPU ops and annotations, for readers that time a
  host range (such as `Optimizer.step#Adam.step`) and for labelling the
  device's idle gaps by what the host was doing then.

While the window is open Python's garbage collector is off, and what set-up
left behind is frozen out of its scans: a collection would stall the
dispatching thread for a time that grows with the process's heap, which
read as a rate falling from quarter to quarter of a window.
"""

from __future__ import annotations

import bisect
import collections
import gc
import time

import torch
from torch.autograd import DeviceType


class Window:
    """Context manager around the timed loop: the host clock always, the
    profiler with `trace`. The window opens at `open()`: on entry, or
    where a driver whose set-up runs inside the program's own call opens it
    (`Driver.opens_window`). `sync` waits for the device's queued work."""

    def __init__(self, trace: bool, sync=None):
        self.trace = trace
        self.sync = sync
        self.prof = None
        self.device_ops = []  # (name, start_ns, end_ns)
        self.host_ops = []  # (name, start_ns, end_ns)
        self.marks = []  # (host time, units of work done)

    def __enter__(self):
        return self

    def open(self):
        """End set-up and start the window: `opened` is set-up's end."""
        if self.sync is not None:
            self.sync()
        self.opened = time.perf_counter()
        gc.collect()
        gc.freeze()
        gc.disable()
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.perf_counter()

    def mark(self, done):
        """Note that `done` units of work have finished by now."""
        self.marks.append((time.perf_counter(), done))

    def quarters(self):
        """The rate (units a second) in each quarter of the window, from
        the marks: whether a slow run is slow throughout or in bursts."""
        times = [t for t, _ in self.marks]
        out, prev_t, prev_n = [], self.t0, 0
        for q in range(1, 5):
            i = bisect.bisect_right(times, self.t0 + q * self.seconds / 4) - 1
            if i < 0 or times[i] <= prev_t:
                out.append(0.0)
                continue
            t, n = self.marks[i]
            out.append((n - prev_n) / (t - prev_t))
            prev_t, prev_n = t, n
        return out

    def close(self):
        """End the window: called by the driver right after its last sync,
        so that the profiler's shutdown is not timed."""
        self.t1 = time.perf_counter()
        gc.enable()
        gc.unfreeze()

    def __exit__(self, *exc):
        if not hasattr(self, "t0"):
            return False
        if not hasattr(self, "t1"):
            self.close()
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self._read()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def _read(self):
        for e in self.prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device_ops.append(span)
            elif e.device_type() == DeviceType.CPU:
                self.host_ops.append(span)
        self.device_ops.sort(key=lambda s: s[1])
        self.host_ops.sort(key=lambda s: s[1])

    # -- what the readers take ---------------------------------------------

    def busy_intervals(self):
        """The union of the device operations' intervals, in order."""
        out = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, *names) -> float:
        """Device time of the operations whose name contains any of
        `names`."""
        return sum(b - a for n, a, b in self.device_ops
                   if any(k in n for k in names)) / 1e9

    def count_device(self) -> int:
        return len(self.device_ops)

    def host_seconds(self, prefix: str) -> float:
        return sum(b - a for n, a, b in self.host_ops
                   if n.startswith(prefix)) / 1e9

    def top_device_ops(self, k=10):
        by = collections.Counter()
        for n, a, b in self.device_ops:
            by[n[:120]] += (b - a) / 1e9
        return [[n, s] for n, s in by.most_common(k)]

    def idle_gaps(self, k=10):
        """The device's idle gaps inside the traced span of device work,
        summed by the outermost host operation running at each gap's
        start ("no host op" where none was)."""
        outer = []  # outermost host ops, non-overlapping, in order
        for n, a, b in self.host_ops:
            if outer and a < outer[-1][2]:
                continue
            outer.append((n, a, b))
        starts = [a for _, a, _ in outer]
        by = collections.Counter()
        busy = self.busy_intervals()
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, end) - 1
            label = (outer[i][0] if i >= 0 and outer[i][2] > end
                     else "no host op")
            by[label[:120]] += (nxt - end) / 1e9
        return [[n, s] for n, s in by.most_common(k)]
