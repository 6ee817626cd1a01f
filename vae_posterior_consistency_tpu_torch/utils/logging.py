"""Console progress and profiling helpers (port of the JAX package's
`utils/logging.py`).

The reference's observability is a tqdm bar printing the total epoch loss
(reference: src/experiment_main/train.py:26,118). `epoch_logger` prints its
line an epoch, `timed` a labelled wall-clock, and `profile_trace` records a
`torch.profiler` trace (the JAX package's `jax.profiler` trace, which the
reference lacks) of everything run inside it and writes it as a Chrome
trace, readable in Perfetto or chrome://tracing. The entry points wrap a
whole run in it under `-profile DIR` (`config.maybe_profile`): a trace of a
long run grows with every operation, so it is meant for short runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def epoch_logger(max_epochs: int) -> Callable[[int, float], None]:
    """A `log_fn` for `train` that prints each epoch in the reference's
    format ('Epoch: [i/max], Total Loss: x', src/experiment_main/
    train.py:118) with the epochs a second so far."""
    start = time.time()

    def log(done: int, loss: float):
        rate = done / max(time.time() - start, 1e-9)
        print(f"Epoch: [{done - 1}/{max_epochs}], Total Loss: {loss}"
              f"  ({rate:.1f} epochs/s)", flush=True)

    return log


@contextlib.contextmanager
def profile_trace(logdir: str = "vpc_trace", device="cpu"):
    """A `torch.profiler.profile` over the block: the CPU's activity, and
    the card's when `device` is a CUDA device. On exit it writes a Chrome
    trace into `logdir`, `trace.<pid>.<ns>.pt.trace.json`. The context's
    value is `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def timed(label: str):
    t0 = time.time()
    yield
    print(f"[timing] {label}: {time.time() - t0:.3f}s")
