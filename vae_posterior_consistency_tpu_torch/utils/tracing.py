"""The program's own spans and counters, recorded only while a torch
profiler records.

`span(name, **attrs)` is a context manager around one layer's work at a
layer boundary (`eval.batch`, `serve.copy_in`, `ops.embed_pool`, ...);
`count(name, n=1)` notes a counter event (`host_reads`). Each span records
its name, its start and end (`time.time_ns()`, the clock torch.profiler's
events are stamped in, so a span lies over the trace's host operations and
device kernels as it is), its own id, the id of the span open around it on
the same thread (`parent`, None for none) and `root`, the id of the
outermost span of that stack: one id shared by every span of one request
(an `eval_vae` call, an `impute` request, a training epoch, an AL episode).
A counter event records the span open around it in the same way.

Both are kept in memory, in one list of plain tuples, capped at `CAP`
records: past it records are dropped and counted (`dropped()`). `spans()`
returns a snapshot of them as `Span` and `Count` tuples, `take()` a
snapshot that it clears. `utils/logging.profile_trace` (`-profile DIR`)
merges `take()` into the Chrome trace it writes; the benchmark's readers
take `spans()` after their traced window.

Recording is on exactly while a torch profiler records (torch's own flag,
`torch.autograd.profiler._is_profiler_enabled`): otherwise `span` returns
one shared no-op object and `count` returns at once, so an untraced run
pays one flag read a site. Inside `muted()` a thread records nothing either:
a kernel's plain version that runs a model's own spanned composition on the
CPU records what the kernel records on the card. Spans are not
`record_function` ranges: they do not appear among the profiler's host
operations, whose labels the benchmark's idle-gap breakdown reads.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: records kept at most until the next `take()`
CAP = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    tid: int
    attrs: dict


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int
    tid: int
    parent: Optional[int]
    root: Optional[int]


if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a torch profiler records now."""
        return _profiler._is_profiler_enabled
else:
    recording = torch.autograd._profiler_enabled

_lock = threading.Lock()  # guards the drop count and the snapshots
_records: list = []  # Span fields (8) or Count fields (6), as plain tuples
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def _thread():
    """This thread's open spans (`stack`) and its native id (`tid`)."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


def _keep(record: tuple) -> None:
    # list.append is atomic under the interpreter lock; threads racing at
    # the cap may pass it by one record each
    global _dropped
    if len(_records) < CAP:
        _records.append(record)
    else:
        with _lock:
            _dropped += 1


class _Open:
    """A span being recorded: pushed on this thread's stack on entry,
    recorded on exit."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack, _ = _thread()
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        stack, tid = _thread()
        stack.pop()
        _keep((self.name, self.start, end, self.id, self.parent, self.root,
               tid, self.attrs))
        return False


class _Off:
    """What `span` returns while no profiler records: does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


OFF = _Off()


def span(name: str, **attrs):
    """A context manager recording span `name` with `attrs` while a torch
    profiler records (and this thread is not `muted`); the shared no-op
    `OFF` otherwise."""
    if not recording() or getattr(_local, "muted", 0):
        return OFF
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Record `n` of counter `name` now, while a torch profiler records
    (and this thread is not `muted`)."""
    if not recording() or getattr(_local, "muted", 0):
        return
    stack, tid = _thread()
    top = stack[-1] if stack else None
    _keep((name, time.time_ns(), n, tid, top and top.id, top and top.root))


@contextlib.contextmanager
def muted():
    """While it lasts, this thread records no span and no counter: a
    kernel's plain version that runs a model's own eager composition (its
    spans and counters included) records what the kernel would, nothing
    inside the caller's span around the call."""
    _local.muted = getattr(_local, "muted", 0) + 1
    try:
        yield
    finally:
        _local.muted -= 1


def _typed(records) -> list:
    return [Span._make(r) if len(r) == len(Span._fields) else Count._make(r)
            for r in records]


def spans() -> list:
    """A snapshot of the records (`Span` and `Count`, in the order they
    ended)."""
    with _lock:
        out = list(_records)
    return _typed(out)


def dropped() -> int:
    """Records dropped past `CAP` since the last `take()`."""
    return _dropped


def take() -> list:
    """`spans()`, and clear the records and the drop count."""
    global _records, _dropped
    with _lock:
        out, _records, _dropped = _records, [], 0
    return _typed(out)


def chrome_events(records, base_ns: int = 0, pid: int = 0) -> list:
    """`records` as Chrome trace events on the timeline of a trace whose
    times count microseconds from `base_ns`: each span a complete event
    ("ph" "X", "cat" "vpc"; args id, parent, root and its attributes), each
    counter event a "C" event of the counter's running total."""
    out, totals = [], {}
    for r in records:
        if isinstance(r, Span):
            out.append({"ph": "X", "cat": "vpc", "name": r.name,
                        "pid": pid, "tid": r.tid,
                        "ts": (r.start_ns - base_ns) / 1e3,
                        "dur": (r.end_ns - r.start_ns) / 1e3,
                        "args": {"id": r.id, "parent": r.parent,
                                 "root": r.root, **r.attrs}})
        else:
            totals[r.name] = totals.get(r.name, 0) + r.n
            out.append({"ph": "C", "cat": "vpc", "name": r.name,
                        "pid": pid, "tid": r.tid,
                        "ts": (r.t_ns - base_ns) / 1e3,
                        "args": {r.name: totals[r.name]}})
    return out
