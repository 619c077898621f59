"""Profiling and throughput metering.

Port of ``tensorflow_ocr_tpu/utils/profiling.py``: :class:`StepTimer`
verbatim (p50/p90 seconds a step, examples/s), :func:`trace` around
``torch.profiler`` (a Chrome trace of the host and the card written to
``logdir``) and :func:`annotate`, a named range in that trace
(``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


class StepTimer:
    """Throughput meter: seconds/step + examples/sec with percentiles."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.time()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "sec_per_step_p50": float(np.percentile(arr, 50)),
            "sec_per_step_p90": float(np.percentile(arr, 90)),
            "examples_per_sec": float(batch_size / arr.mean()),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (the host, and the card when there is
    one), written to ``logdir/trace.json``; does nothing where the
    profiler cannot start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception:
                pass


def annotate(name: str):
    """A named range in the profiler's trace
    (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
