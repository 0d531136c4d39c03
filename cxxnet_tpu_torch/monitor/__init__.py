"""Observability: a structured event stream beside the printed lines
(counterpart of ``cxxnet_tpu/monitor/__init__.py``).

The printed lines (the round eval line, the ``round %8d:[%8d]``
progress line, each task's closing line) are the parity surface and
print unchanged; the records go beside them. The keys, read from the
config as the reference reads them:

- ``monitor = none|stdout|jsonl``: the sink. ``none`` (the default) is
  a no-op: no per-update device sync, no clock reads, no records.
- ``monitor_path``: the JSONL file of ``monitor = jsonl`` (default
  ``monitor.jsonl``; truncated per run: one file is one run's stream).
- ``monitor_flush_period``: seconds between flushes (0: every record).
- ``monitor_rotate_mb``: a size bound on the live JSONL file (0: none);
  past it the file rotates to ``<path>.<n>``.
- ``monitor_trace_dir``: a ``torch.profiler`` trace (CPU and, on a
  GPU, CUDA activities) over a round window, written there as a Chrome
  trace; it runs under ``monitor = none`` too.
- ``monitor_trace_begin`` / ``monitor_trace_end``: the window's first
  and last round (0-based); both default to round 1.

The port runs one process, so it is always the root that emits. The
record vocabulary and its validation are in :mod:`.schema`; warnings go
through :func:`warn_once`, once per code and run.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Monitor", "NullSink", "StdoutSink", "JsonlSink", "MemorySink",
    "LatencyHistogram", "SafeEmitter", "create_monitor", "config_hash",
    "run_metadata", "device_memory_snapshot", "get_global", "set_global",
    "warn_once", "reset_warnings",
]

_WARN_PREFIX = "[cxxnet_tpu_torch] warning"


def _stderr(text: str) -> None:
    """A line on stderr that never raises: warnings come from fallback
    and cleanup paths (a checkpoint writer thread among them)."""
    try:
        sys.stderr.write(text)
    except (OSError, ValueError):
        pass    # a closed stderr must not turn a warning into a crash


# -- sinks ---------------------------------------------------------------


class NullSink:
    """Drops everything; ``Monitor.enabled`` is False over it, so
    callers skip assembling records."""

    enabled = False

    def write(self, record: Dict[str, Any]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class StdoutSink:
    """Records as JSON lines on stdout between the printed lines, which
    stay as they are (dropping the lines that start with ``{`` gives the
    unmonitored output). ``log`` records are dropped: ``Monitor.line``
    printed their text already."""

    enabled = True

    def write(self, record: Dict[str, Any]) -> None:
        if record.get("event") == "log":
            return
        sys.stdout.write(json.dumps(record, sort_keys=True) + "\n")

    def flush(self) -> None:
        sys.stdout.flush()

    def close(self) -> None:
        self.flush()


class JsonlSink:
    """Records to a JSONL file, flushed every ``flush_period`` seconds
    (0: every record); ``close`` drains. The file is truncated per run,
    and the rotated segments of an earlier run at the same path go too.

    ``rotate_mb`` > 0 bounds the live file: once a write takes it past
    the bound, it is renamed to ``<path>.<n>`` (``os.replace``: a reader
    of the live path sees the old stream or the new one) and a fresh
    file continues the run, at record boundaries. A failed rotation
    warns once on stderr and the stream keeps appending to the current
    file: the bound is lost, never a record."""

    enabled = True

    def __init__(self, path: str, flush_period: float = 1.0,
                 rotate_mb: float = 0.0):
        self.path = path
        self.flush_period = max(0.0, float(flush_period))
        self.rotate_bytes = int(max(0.0, float(rotate_mb)) * 1e6)
        self.rotations = 0
        self._written = 0
        self._rotate_broken = False
        n = 1
        while True:
            try:
                os.remove("%s.%d" % (path, n))
            except OSError:
                break                    # the first gap ends the chain
            n += 1
        self._f = open(path, "w")
        self._last_flush = time.monotonic()
        # the serve workers and the checkpoint writer emit from their
        # own threads into the one stream
        self._wlock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._wlock:
            self._f.write(line)
            self._written += len(line)
            if self.rotate_bytes and self._written >= self.rotate_bytes:
                self._rotate_locked()
            now = time.monotonic()
            if now - self._last_flush >= self.flush_period:
                self._f.flush()
                self._last_flush = now

    def _rotate_locked(self) -> None:
        """Rename the live file aside and open a fresh one (under
        ``_wlock``). Never raises: the warning is latched here, since
        routing it through the monitor would re-enter this sink."""
        if self._rotate_broken:
            return
        try:
            self._f.flush()
            os.replace(self.path, "%s.%d" % (self.path,
                                             self.rotations + 1))
        except OSError as e:
            self._rotate_broken = True
            _stderr("%s monitor_rotate_failed: could not rotate %r (%s); "
                    "the stream keeps appending to the current file "
                    "without a size bound\n" % (_WARN_PREFIX, self.path, e))
            return
        old = self._f
        try:
            self._f = open(self.path, "w")
        except OSError as e:
            # the rename committed but no fresh file opens: go on in the
            # renamed one, still a whole stream
            self._f = old
            self._rotate_broken = True
            _stderr("%s monitor_rotate_failed: rotated %r but could not "
                    "reopen it (%s); records continue into the rotated "
                    "file\n" % (_WARN_PREFIX, self.path, e))
            return
        old.close()
        self.rotations += 1
        self._written = 0

    def flush(self) -> None:
        with self._wlock:
            self._f.flush()
            self._last_flush = time.monotonic()

    def close(self) -> None:
        with self._wlock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class MemorySink:
    """Records in a list: the sink of tests and in-process callers."""

    enabled = True

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def clear(self) -> None:
        self.records = []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


# -- latency histogram ---------------------------------------------------


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

    def snapshot(self) -> Dict[str, Any]:
        """The ``io_wait`` record's fields."""
        buckets = {}
        for i, b in enumerate(self.BOUNDS):
            if self.counts[i]:
                buckets["<=%gms" % b] = self.counts[i]
        if self.counts[-1]:
            buckets[">%gms" % self.BOUNDS[-1]] = self.counts[-1]
        mean = self.total_ms / self.n if self.n else 0.0
        return {"count": self.n, "total_ms": round(self.total_ms, 3),
                "mean_ms": round(mean, 3),
                "max_ms": round(self.max_ms, 3),
                "p50_ms": round(self.percentile(0.50), 3),
                "p99_ms": round(self.percentile(0.99), 3),
                "buckets": buckets}


# -- monitor -------------------------------------------------------------


class Monitor:
    """An event logger over one sink.

    ``line(text)`` prints a parity line exactly as the unmonitored code
    does, and an enabled sink records it as a ``log`` event.
    ``emit(event, **fields)`` is the structured channel, a no-op over a
    null sink. The trace window runs ``torch.profiler`` whatever the
    sink.
    """

    def __init__(self, sink=None, trace_dir: str = "",
                 trace_begin: int = 1, trace_end: Optional[int] = None):
        self.sink = sink if sink is not None else NullSink()
        self.trace_dir = trace_dir
        self.trace_begin = trace_begin
        self.trace_end = trace_begin if trace_end is None else trace_end
        self._profiler = None            # torch.profiler.profile, tracing
        self._trace_started = False
        self._trace_first = self._trace_round = trace_begin
        self._warn_lock = threading.Lock()
        self._warned: set = set()

    @property
    def enabled(self) -> bool:
        return self.sink.enabled

    @property
    def _tracing(self) -> bool:
        return self._profiler is not None

    def emit(self, event: str, **fields: Any) -> None:
        if not self.sink.enabled:
            return
        record = {"event": event, "t": time.time()}
        record.update(fields)
        self.sink.write(record)

    def line(self, text: str) -> None:
        """Print a parity stdout line (flushed, so a preempted process
        leaves it behind); record it when enabled."""
        print(text, flush=True)
        if self.sink.enabled:
            self.emit("log", text=text)

    def warn_once(self, code: str, message: str) -> None:
        """One stderr line and one ``warning`` record per code and run.
        Never raises: a dead sink must not turn a warning into a
        crash."""
        with self._warn_lock:
            if code in self._warned:
                return
            self._warned.add(code)
        _stderr("%s %s: %s\n" % (_WARN_PREFIX, code, message))
        try:
            self.emit("warning", code=code, message=message)
        except Exception:
            pass    # the stderr line above delivered the warning

    # -- profiler trace window ------------------------------------------

    def maybe_start_trace(self, round_idx: int) -> None:
        """Start at the first round seen at or past ``trace_begin`` (a
        resumed run may begin past the window: a late trace beats
        none); a run traces one window, once. A profiler that will not
        start (another one is running) warns ``trace_start_failed`` and
        the run goes on untraced."""
        if (not self.trace_dir or self._trace_started
                or round_idx < self.trace_begin):
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            if torch.autograd.profiler._is_profiler_enabled:
                # a second session would end the caller's own
                raise RuntimeError("another profiler is running")
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:   # the profiler is best-effort
            self.warn_once("trace_start_failed",
                           "torch.profiler failed to start: %s" % e)
            return
        self._profiler = prof
        self._trace_started = True
        self._trace_first = self._trace_round = round_idx
        self.emit("trace_start", dir=self.trace_dir, round=round_idx)

    def maybe_stop_trace(self, round_idx: int,
                         force: bool = False) -> None:
        """Stop after ``trace_end`` (or on ``close``) and write the
        Chrome trace ``<trace_dir>/trace_r<first>-<last>.json``."""
        if not self._tracing:
            return
        if not force and round_idx < self.trace_end:
            self._trace_round = round_idx    # the last round seen tracing
            return
        if force:
            # a stop at close: the last traced round, not the caller's 0
            round_idx = max(round_idx, self._trace_round)
        prof, self._profiler = self._profiler, None
        path = os.path.join(self.trace_dir, "trace_r%d-%d.json"
                            % (self._trace_first, round_idx))
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:
            # no trace was written: no trace_stop record claims one
            self.warn_once("trace_stop_failed",
                           "torch.profiler failed to stop or write %s: %s"
                           % (path, e))
            return
        self.emit("trace_stop", dir=self.trace_dir, round=round_idx,
                  path=path, bytes=os.path.getsize(path))

    def close(self) -> None:
        self.maybe_stop_trace(0, force=True)
        if self.trace_dir and not self._trace_started:
            self.warn_once(
                "trace_never_started",
                "monitor_trace_dir was set but no round >= "
                "monitor_trace_begin (%d) ran; no trace captured"
                % self.trace_begin)
        self.sink.close()


# -- construction --------------------------------------------------------


def config_hash(cfg) -> str:
    """A digest of the whole ordered (name, value) config stream: ties a
    record stream to its run's configuration."""
    text = "\n".join("%s=%s" % (k, v) for k, v in cfg)
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def create_monitor(cfg, root: bool = True) -> Monitor:
    """A Monitor from ``key = value`` config pairs. ``root = False``
    gives a null sink and no trace (one stream per run); the port runs
    one process, so it is the root."""
    mode = "none"
    path = "monitor.jsonl"
    flush_period = 1.0
    rotate_mb = 0.0
    trace_dir = ""
    trace_begin, trace_end = 1, None
    for name, val in cfg:
        if name == "monitor":
            if val not in ("none", "stdout", "jsonl"):
                raise ValueError(
                    "monitor must be none|stdout|jsonl, got %r" % val)
            mode = val
        if name == "monitor_path":
            path = val
        if name == "monitor_flush_period":
            flush_period = float(val)
        if name == "monitor_rotate_mb":
            rotate_mb = float(val)
        if name == "monitor_trace_dir":
            trace_dir = val
        if name == "monitor_trace_begin":
            trace_begin = int(val)
        if name == "monitor_trace_end":
            trace_end = int(val)
    if not root:
        mode, trace_dir = "none", ""
    if mode == "stdout":
        sink = StdoutSink()
    elif mode == "jsonl":
        sink = JsonlSink(path, flush_period, rotate_mb=rotate_mb)
    else:
        sink = NullSink()
    return Monitor(sink, trace_dir=trace_dir, trace_begin=trace_begin,
                   trace_end=trace_end)


def run_metadata(task: str, cfg, device=None) -> Dict[str, Any]:
    """The ``run_start`` record's fields. ``device`` is the run's
    ``torch.device`` (None: the GPU when there is one). ``jax_version``
    is required by the schema and is None: the port runs no JAX."""
    import platform as _platform

    import torch
    dev = device if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    gpu = getattr(dev, "type", str(dev)) == "cuda"
    return {
        "task": task,
        "config_hash": config_hash(cfg),
        "jax_version": None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": _platform.python_version(),
        "platform": "gpu" if gpu else "cpu",
        "process_count": 1,
        "process_index": 0,
        "device_count": torch.cuda.device_count() if gpu else 1,
        "device_kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
        "mesh": None,
    }


def device_memory_snapshot(device=None) -> Dict[str, Any]:
    """Memory of the run's device, a host-side query (no device work):
    on CUDA ``torch.cuda.memory_stats`` (allocated bytes, current and
    peak) and ``mem_get_info`` (the card's total as the limit); on the
    CPU ``available: False``, as the reference reports a CPU backend."""
    import torch
    dev = device if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if getattr(dev, "type", str(dev)) != "cuda":
        return {"available": False,
                "devices": [{"id": 0, "kind": "cpu"}]}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    idx = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return {"available": True, "devices": [{
        "id": idx, "kind": torch.cuda.get_device_name(dev),
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total)}]}


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


# -- the global monitor (the warn-once channel of deep call sites) -------

_global_monitor: Optional[Monitor] = None
_warned: set = set()
_warned_lock = threading.Lock()


def set_global(mon: Optional[Monitor]) -> None:
    """Install the run's monitor, so deep call sites (checkpoint
    writers, stream retries) reach its stream."""
    global _global_monitor
    _global_monitor = mon


def get_global() -> Optional[Monitor]:
    return _global_monitor


def warn_once(code: str, message: str) -> None:
    """A warning through the installed monitor (once per code and run),
    or with none installed one stderr line per code until
    :func:`reset_warnings`. Never raises."""
    mon = _global_monitor
    if mon is not None:
        mon.warn_once(code, message)
        return
    with _warned_lock:
        if code in _warned:
            return
        _warned.add(code)
    _stderr("%s %s: %s\n" % (_WARN_PREFIX, code, message))


def reset_warnings() -> None:
    """Start a new run: every code warns once again."""
    with _warned_lock:
        _warned.clear()
