"""Telemetry pieces the port needs (copies from
``cxxnet_tpu/monitor/__init__.py``): the O(1) latency histogram and the
fail-safe emitter of the serve batcher, and ``warn_once`` (with
``reset_warnings``, which the CLI calls as each run starts). The monitor,
its sinks and the record schema come with the telemetry item."""

from __future__ import annotations

import sys
import threading
from typing import Any

_warned: set = set()
_warned_lock = threading.Lock()


def warn_once(code: str, message: str) -> None:
    """One stderr line per warning ``code`` and run (``reset_warnings``
    starts a run; without it, per process). Never raises:
    it is called from fallback and cleanup paths (a checkpoint writer
    thread among them)."""
    with _warned_lock:
        if code in _warned:
            return
        _warned.add(code)
    try:
        sys.stderr.write("[cxxnet_tpu_torch] warning %s: %s\n"
                         % (code, message))
    except (OSError, ValueError):
        pass    # a closed stderr must not turn a warning into a crash


def reset_warnings() -> None:
    """Start a new run: every code warns once again."""
    with _warned_lock:
        _warned.clear()


class LatencyHistogram:
    """Power-of-two millisecond buckets for host-side latencies;
    ``observe`` is O(1)."""

    # bucket upper bounds in ms; last bucket is open-ended
    BOUNDS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
              256.0, 512.0, 1024.0)

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.n = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def observe(self, seconds: float) -> None:
        ms = seconds * 1e3
        self.n += 1
        self.total_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        for i, b in enumerate(self.BOUNDS):
            if ms <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 1]): linear
        interpolation inside the bucket the rank lands in, capped by the
        observed max."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        seen = 0
        lo = 0.0
        for i, hi in enumerate(self.BOUNDS):
            c = self.counts[i]
            if seen + c >= rank and c > 0:
                frac = (rank - seen) / c
                return min(lo + (hi - lo) * frac, self.max_ms)
            seen += c
            lo = hi
        return self.max_ms               # rank in the open-ended bucket


class SafeEmitter:
    """Emit wrapper for worker-thread telemetry: a sink failure must
    neither kill the emitting thread nor spam — the first failure
    prints one stderr line and serving continues without records.
    ``monitor`` is any object with ``enabled`` and ``emit(kind,
    **fields)``, or None."""

    def __init__(self, monitor, label: str):
        self._mon = monitor
        self._label = label
        self._lock = threading.Lock()
        self._broken = False

    def __call__(self, kind: str, **fields: Any) -> None:
        if self._mon is None or not self._mon.enabled:
            return
        try:
            self._mon.emit(kind, **fields)
        except Exception as e:
            with self._lock:
                already, self._broken = self._broken, True
            if not already:
                print("%s: telemetry emit failed (continuing without "
                      "records): %s" % (self._label, e),
                      file=sys.stderr)
