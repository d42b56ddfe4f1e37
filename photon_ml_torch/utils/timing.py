"""Device timing under asynchronous launches.

Counterpart of ``photon_ml_tpu/utils/timing.py``.  A CUDA launch returns
before its kernel runs, so a host clock without a fence measures the
launch.  ``device_fence`` waits for the card (``torch.cuda.synchronize``;
nothing on the CPU, where every call has finished when it returns).
``measure`` times back-to-back calls between two CUDA events on the
current stream and synchronizes once: the stream runs them in order, so
the interval over ``iters`` is the time a call once the queue is deeper
than the launch latency.  On the CPU it is the host clock around the
same loop.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _device_of(out) -> torch.device | None:
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _device_of(x)
            if dev is not None:
                return dev
    if isinstance(out, dict):
        return _device_of(list(out.values()))
    return None


def device_fence(out=None) -> None:
    """Block until the work that produced ``out`` has run on its card
    (every CUDA device when ``out`` names none)."""
    dev = _device_of(out)
    if dev is not None and dev.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(dev)


def measure(fn: Callable, *args, iters: int = 20, warmup: int = 1,
            device=None) -> float:
    """Seconds a call: ``iters`` calls back to back between two CUDA
    events on ``device`` (default: the device of the warm-up's result),
    after ``warmup`` calls and a fence."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    dev = torch.device(device) if device is not None else _device_of(out)
    if dev is None or dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(iters):
        fn(*args)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
