"""Timing and profiling helpers (SURVEY.md §5), the counterpart of
directxtex_tpu/utils/timing.py.

The reference exposes only texconv's -timing wall clock; `timed` adds a
context whose clock stops after the device has finished the block's work
(a CUDA synchronize on the device it is given, CUDA unless named; a CPU
device has nothing to wait for), and `profile_trace` records the block
with torch.profiler and writes a Chrome trace (chrome://tracing,
Perfetto) into a directory. A failing synchronize raises: the time of a
block whose device work failed is not a time.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .device import resolve

__all__ = ["timed", "profile_trace", "synchronize"]


def synchronize(device=None) -> None:
    """Wait for the device's queued work (CUDA unless named; nothing on
    the CPU)."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(label: str = "", sync: bool = True, log=print, device=None):
    """Wall-clock a block, waiting for `device`'s work at its end when
    `sync`. The seconds land in the yielded dict."""
    t0 = time.perf_counter()
    result = {}
    try:
        yield result
    finally:
        if sync:
            synchronize(device)
        dt = time.perf_counter() - t0
        result["seconds"] = dt
        if label:
            log(f"[timing] {label}: {dt:.4f}s")


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """torch.profiler around a block (the host's ops, and CUDA's kernels
    and copies where `device` is CUDA, the default); on exit the Chrome
    trace is written to `logdir`/trace.json, whose path the yielded dict
    holds."""
    dev = resolve(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {"path": os.path.join(str(logdir), "trace.json")}
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        synchronize(dev)
    os.makedirs(str(logdir), exist_ok=True)
    prof.export_chrome_trace(out["path"])
