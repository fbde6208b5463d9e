"""Tracing / profiling / observability utilities.

The counterpart of the reference's STATUS_LOG/DONE_LOG/TIME_LOG timer
macros (spumoni_main.hpp:46-54), malloc_count heap hooks, and the
*.{ms,pml}_index_stats.txt size accounting (compute_ms_pml.cpp:204-209):

  * phase timers with the same "[tag] msg ... done. (x.xxx sec)" shape
  * an optional JAX profiler trace around any phase (xplane dumps)
  * device-memory footprint reporting for device-resident index arrays
"""

from __future__ import annotations

import contextlib
import sys
import time


VERBOSE = True


def log(tag: str, msg: str) -> None:
    if VERBOSE:
        print(f"[{tag}] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def phase(tag: str, msg: str):
    """STATUS_LOG/DONE_LOG pair (spumoni_main.hpp:46-49)."""
    if VERBOSE:
        print(f"[{tag}] {msg} ... ", file=sys.stderr, end="", flush=True)
    t0 = time.time()
    try:
        yield
    finally:
        if VERBOSE:
            print(f"done.  ({time.time() - t0:.3f} sec)", file=sys.stderr,
                  flush=True)


class PhaseTimer:
    """Accumulates named phase durations; summary() mirrors the reference's
    per-phase build timing output."""

    def __init__(self):
        self.durations: dict[str, float] = {}

    @contextlib.contextmanager
    def track(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + (
                time.time() - t0)

    def summary(self) -> str:
        total = sum(self.durations.values())
        lines = [f"  {name:<30s} {dur:8.3f}s ({100 * dur / max(total, 1e-9):.1f}%)"
                 for name, dur in self.durations.items()]
        lines.append(f"  {'total':<30s} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def jax_trace(trace_dir: str | None):
    """Wraps a phase in a JAX profiler trace (xplane) when trace_dir is set."""
    if not trace_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def present_chars(a):
    """Distinct byte values present in `a`, as a small int array.

    Replaces np.unique on read batches: np.unique SORTS its input, while a
    histogram is O(n)."""
    import numpy as np
    return np.nonzero(np.bincount(a.reshape(-1), minlength=256))[0]


def encode_rows(reads, B: int, L: int, want_fwd: bool = True):
    """(fwd, rev, lens): [B, L] u8 lockstep rows from byte-string reads.

    fwd[i] = read bytes left-aligned, rev[i] = reversed bytes left-aligned,
    lens[i] = read length; rows past len(reads) stay zero (padding lanes).
    Uniform-length batches — the overwhelmingly common case, since callers
    bucket reads by padded length — take one C-speed join + reshape instead
    of a per-read Python loop."""
    import numpy as np
    nr = len(reads)
    lens = np.zeros((B,), dtype=np.int64)
    if nr:
        lens[:nr] = np.fromiter((len(r) for r in reads), np.int64, nr)
    fwd = np.zeros((B, L), dtype=np.uint8) if want_fwd else None
    rev = np.zeros((B, L), dtype=np.uint8)
    if nr and lens[0] and (lens[:nr] == lens[0]).all():
        l0 = int(lens[0])
        rows = np.frombuffer(b"".join(bytes(r) for r in reads),
                             np.uint8).reshape(nr, l0)
        if want_fwd:
            fwd[:nr, :l0] = rows
        rev[:nr, :l0] = rows[:, ::-1]
    else:
        for i, rd in enumerate(reads):
            a = np.frombuffer(bytes(rd), dtype=np.uint8)
            lens[i] = len(a)  # byte count, not element count: a non-uint8
            #                   array input must record its BYTE length so
            #                   lens stays consistent with the written rows
            if want_fwd:
                fwd[i, :len(a)] = a
            rev[i, :len(a)] = a[::-1]
    return fwd, rev, lens


def device_array_footprint(arrays) -> dict[str, int]:
    """Bytes of every device array in a pytree — the HBM analog of the
    index stats files."""
    import jax

    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(arrays)
    for path, leaf in flat:
        if hasattr(leaf, "nbytes"):
            out[jax.tree_util.keystr(path)] = int(leaf.nbytes)
    out["__total__"] = sum(v for k, v in out.items() if k != "__total__")
    return out


def hbm_usage() -> dict:
    """Live/peak/limit device memory from the backend ({} where the
    backend reports none, as the CPU backend does)."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return {k: stats[k] for k in
            ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
            if k in stats}


#: share of the device's memory limit kept free of index arrays: staged read
#: batches, [B, L] value matrices and compiler scratch live there
HBM_HEADROOM = 0.25


def hbm_budget() -> float | None:
    """Per-device bytes an engine's index may occupy: SPN_HBM_BUDGET_GB when
    set, else the backend's memory limit less HBM_HEADROOM. None when the
    backend reports no limit (the CPU backend): no size is assumed."""
    import os

    env = os.environ.get("SPN_HBM_BUDGET_GB")
    if env:
        return float(env) * 1e9
    limit = hbm_usage().get("bytes_limit")
    return limit * (1 - HBM_HEADROOM) if limit else None
