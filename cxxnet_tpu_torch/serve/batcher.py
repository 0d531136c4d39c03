"""Dynamic micro-batching dispatcher with backpressure (a copy of
``cxxnet_tpu/serve/batcher.py``, same semantics).

Concurrent clients submit one example or a small row array; a
coalescing queue closes a micro-batch when ``max_batch`` rows are
pending or the oldest request has waited ``max_delay_ms``; the batch
pads to its bucket and dispatches; per-request futures resolve with the
request's own rows of the result.

- **bounded queue / reject-with-busy** — ``submit`` raises
  :class:`ServeBusyError` the moment pending rows would exceed
  ``max_queue_rows``.
- **per-request deadlines** — a request still queued when its deadline
  passes fails with :class:`ServeTimeoutError` at batch-form time.
- **exception propagation** — an engine failure resolves exactly the
  futures of the batch that hit it; the loop keeps serving.
- **graceful shutdown** — ``close(drain=True)`` stops intake, runs
  every queued request, then joins the workers; ``drain=False`` fails
  the queue fast with :class:`ServeClosedError`.
- **pipelined hand-off** — a collector thread stages batch N+1's
  host-to-device copy while the dispatch thread computes batch N,
  through a depth-bounded queue between them.

Telemetry: per-request ``serve_request``, per-micro-batch
``serve_batch`` and one ``serve_summary`` at close, through the
optional monitor.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..monitor import LatencyHistogram, SafeEmitter


class ServeBusyError(RuntimeError):
    """Queue full: the server sheds this request instead of queueing."""


class ServeTimeoutError(TimeoutError):
    """The request's deadline passed while it waited in the queue."""


class ServeClosedError(RuntimeError):
    """The server is shut down (or shutting down without drain)."""


def _set_exception(future: Future, exc: BaseException) -> None:
    """Fail a future that might have been cancelled by its client
    meanwhile — a cancelled future refuses set_exception, and that
    refusal must never kill a serve worker thread."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass  # the client cancelled first; the failure has no recipient


class _Call:
    """A callable queued for the dispatch thread."""
    __slots__ = ("fn", "future")

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.future: Future = Future()


class _Request:
    __slots__ = ("rows", "n", "future", "t_submit", "deadline")

    def __init__(self, rows: np.ndarray, deadline: Optional[float]):
        self.rows = rows
        self.n = rows.shape[0]
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline


class DynamicBatcher:
    """Coalesce request rows into bucketed micro-batches.

    ``stage_fn(rows) -> staged`` issues the H2D transfer (cheap,
    async); it receives ONE row array for a single-request batch and a
    LIST of per-request row arrays for a coalesced one (so an engine
    with a preallocated staging ring assembles client rows in a single
    copy). ``dispatch_fn(staged) -> np.ndarray`` runs the executable
    and returns one output row per input row. The split exists so the
    two halves can overlap across consecutive batches.
    """

    def __init__(self, stage_fn: Callable[[np.ndarray], Any],
                 dispatch_fn: Callable[[Any], np.ndarray],
                 max_batch: int, max_delay_ms: float = 2.0,
                 max_queue_rows: int = 0, timeout_ms: float = 0.0,
                 monitor=None, stage_depth: int = 2,
                 extra_summary: Optional[Callable[[], Dict[str, Any]]]
                 = None, row_shape: Optional[tuple] = None):
        self._stage_fn = stage_fn
        self._dispatch_fn = dispatch_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.max_queue_rows = int(max_queue_rows) or 8 * self.max_batch
        if self.max_queue_rows < self.max_batch:
            # a bound below max_batch would shed every full-size
            # request forever with a "queue full" that blames load that
            # does not exist — surface the misconfiguration at startup
            raise ValueError(
                "max_queue_rows (%d) must be >= max_batch (%d)"
                % (self.max_queue_rows, self.max_batch))
        self.default_timeout_s = max(0.0, float(timeout_ms)) / 1e3
        self._extra_summary = extra_summary
        # per-row shape every request must match (so one client cannot
        # poison a coalesced batch for the others); None = adopt the
        # first request's shape
        self._row_shape = None if row_shape is None else tuple(row_shape)
        self._pending: deque = deque()
        self._pending_rows = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._staged_q: "queue.Queue" = queue.Queue(max(1, stage_depth))
        self._closed = False
        self._t0 = time.monotonic()
        # leaf lock for the cross-thread stats (collector, dispatcher
        # and submit all mutate them; += on a dict slot is not atomic)
        self._stats = threading.Lock()
        self._safe_emit = SafeEmitter(monitor, "cxxnet_tpu_torch serve")
        self._lat = LatencyHistogram()   # request latencies, always on
        self.counters: Dict[str, int] = {
            "requests": 0, "rows": 0, "batches": 0, "batch_rows": 0,
            "bucket_rows": 0, "pad_rows": 0, "rejected": 0,
            "timeouts": 0, "cancelled": 0, "errors": 0}
        self._collector = threading.Thread(
            target=self._collect_loop, name="serve-collect", daemon=True)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatch",
            daemon=True)
        self._collector.start()
        self._dispatcher.start()

    # -- client surface --------------------------------------------------

    def submit(self, rows: np.ndarray,
               timeout_ms: Optional[float] = None) -> Future:
        """Queue ``rows`` (leading axis = batch, 1..max_batch rows) and
        return the Future of their result rows. Raises ServeBusyError
        on a full queue, ServeClosedError after shutdown."""
        rows = np.asarray(rows)
        if rows.shape[0] < 1 or rows.shape[0] > self.max_batch:
            raise ValueError(
                "request must carry 1..%d rows, got %d"
                % (self.max_batch, rows.shape[0]))
        t = self.default_timeout_s if timeout_ms is None \
            else max(0.0, float(timeout_ms)) / 1e3
        req = _Request(rows, time.monotonic() + t if t > 0 else None)
        shed = None
        with self._lock:
            if self._closed:
                raise ServeClosedError("serve batcher is closed")
            # rows coalesce into one array with other clients' rows —
            # a mismatched shape must bounce to THIS caller, not blow
            # up the shared batch
            if self._row_shape is None:
                self._row_shape = rows.shape[1:]
            elif rows.shape[1:] != self._row_shape:
                raise ValueError(
                    "request row shape %r does not match the served "
                    "shape %r" % (rows.shape[1:], self._row_shape))
            if self._pending_rows + req.n > self.max_queue_rows:
                shed = self._pending_rows
            else:
                self._pending.append(req)
                self._pending_rows += req.n
                self._wake.notify_all()
        if shed is not None:
            # telemetry outside the queue lock: overload shedding must
            # stay cheap, not serialize every submitter behind sink I/O
            with self._stats:
                self.counters["rejected"] += 1
            self._emit_request("busy", req, 0.0)
            raise ServeBusyError(
                "queue full (%d rows pending, limit %d)"
                % (shed, self.max_queue_rows))
        return req.future

    def __call__(self, rows: np.ndarray,
                 timeout_ms: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit and wait for the result."""
        return self.submit(rows, timeout_ms).result()

    def run_in_dispatcher(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn()`` on the dispatch thread, in order with the
        batches staged before it, and return its result (or raise its
        exception). Work whose per-thread state must be the dispatch
        thread's — a warmup — goes through here."""
        call = _Call(fn)
        with self._lock:
            if self._closed:
                raise ServeClosedError("serve batcher is closed")
            # under the lock: close() cannot slip its end-of-queue mark
            # ahead of this call
            self._staged_q.put(call)
        return call.future.result()

    # -- collector: coalesce + stage -------------------------------------

    def _collect_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if not self._pending:     # closed and drained
                    break
                window_end = self._pending[0].t_submit + self.max_delay_s
                # wait for the micro-batch to fill or the delay window
                # to pass (closing flushes immediately: drain must not
                # sit out the delay per batch)
                while (self._pending_rows < self.max_batch
                       and not self._closed):
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(remaining)
                batch, dropped, cancelled = [], [], 0
                total = 0
                now = time.monotonic()
                while self._pending:
                    req = self._pending[0]
                    if req.deadline is not None and now > req.deadline:
                        self._pending.popleft()
                        self._pending_rows -= req.n
                        dropped.append(req)
                        continue
                    if total + req.n > self.max_batch:
                        break
                    self._pending.popleft()
                    self._pending_rows -= req.n
                    # batch-form is the commit point: a future the
                    # client already cancelled leaves the batch here
                    # (after this call the future can no longer be
                    # cancelled, so set_result below cannot throw)
                    if not req.future.set_running_or_notify_cancel():
                        cancelled += 1
                        continue
                    batch.append(req)
                    total += req.n
            if cancelled:
                with self._stats:
                    self.counters["cancelled"] += cancelled
            for req in dropped:
                wait_ms = (now - req.t_submit) * 1e3
                with self._stats:
                    self.counters["timeouts"] += 1
                    self._lat.observe(now - req.t_submit)
                self._emit_request("timeout", req, wait_ms,
                                   latency_ms=wait_ms)
                _set_exception(req.future, ServeTimeoutError(
                    "request expired after %.1f ms in queue" % wait_ms))
            if not batch:
                continue
            try:
                # a multi-request batch hands the per-request row
                # arrays straight to stage: the engine assembles them
                # into its preallocated staging buffer in ONE copy
                # (client array -> H2D source) instead of paying a
                # concatenate copy first
                staged = self._stage_fn(
                    batch[0].rows if len(batch) == 1
                    else [r.rows for r in batch])
            except Exception as e:
                self._fail_batch(batch, e, t_form=now)
                continue
            # blocks when stage_depth batches are already in flight —
            # H2D stays at most one batch ahead of compute, and the
            # backpressure propagates into the bounded pending queue
            self._staged_q.put((staged, batch, now))
        self._staged_q.put(None)

    # -- dispatcher: compute + resolve -----------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            item = self._staged_q.get()
            if item is None:
                break
            if isinstance(item, _Call):
                try:
                    item.future.set_result(item.fn())
                except Exception as e:
                    item.future.set_exception(e)
                continue
            staged, batch, t_form = item
            t0 = time.monotonic()
            try:
                out = self._dispatch_fn(staged)
            except Exception as e:
                self._fail_batch(batch, e, staged=staged,
                                 device_ms=(time.monotonic() - t0) * 1e3,
                                 t_form=t_form)
                continue
            device_ms = (time.monotonic() - t0) * 1e3
            t_done = time.monotonic()
            offset = 0
            # resolve every future before any telemetry: sink I/O
            # (json + locked file write) must not sit on the client
            # latency path
            for req in batch:
                res = out[offset:offset + req.n]
                offset += req.n
                req.future.set_result(res)
            for req in batch:
                with self._stats:
                    self.counters["requests"] += 1
                    self.counters["rows"] += req.n
                    self._lat.observe(t_done - req.t_submit)
                self._emit_request("ok", req,
                                   (t_form - req.t_submit) * 1e3,
                                   latency_ms=(t_done - req.t_submit)
                                   * 1e3)
            self._note_batch(batch, staged, t_form, device_ms, "ok")

    def _fail_batch(self, batch, exc, staged=None,
                    device_ms: float = 0.0,
                    t_form: Optional[float] = None) -> None:
        t_done = time.monotonic()
        for req in batch:
            with self._stats:
                self.counters["errors"] += 1
                self._lat.observe(t_done - req.t_submit)
            self._emit_request("error", req,
                               ((t_form or t_done) - req.t_submit) * 1e3,
                               latency_ms=(t_done - req.t_submit) * 1e3)
            _set_exception(req.future, exc)
        if t_form is not None:
            self._note_batch(batch, staged, t_form, device_ms, "error")

    # -- telemetry -------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        """Emit a serve record, never letting a sink failure (full
        disk, closed file) escape — a telemetry error must not kill a
        worker thread and hang every waiting client. SafeEmitter owns
        the warn-once latch."""
        self._safe_emit(kind, **fields)

    def _emit_request(self, status: str, req: _Request,
                      queue_ms: float, latency_ms: float = 0.0) -> None:
        self._emit("serve_request", status=status, rows=req.n,
                   queue_ms=queue_ms, latency_ms=latency_ms)

    def _note_batch(self, batch, staged, t_form: float,
                    device_ms: float, status: str) -> None:
        rows = sum(r.n for r in batch)
        bucket = getattr(staged, "bucket", rows)
        with self._stats:
            self.counters["batches"] += 1
            self.counters["batch_rows"] += rows
            self.counters["bucket_rows"] += bucket
            self.counters["pad_rows"] += bucket - rows
            nbatch = self.counters["batches"]
        oldest = min(r.t_submit for r in batch)
        self._emit(
            "serve_batch", batch=nbatch, status=status,
            rows=rows, requests=len(batch), bucket=bucket,
            pad_rows=bucket - rows,
            fill_rate=rows / float(self.max_batch),
            pad_fraction=(bucket - rows) / float(bucket),
            queue_ms=(t_form - oldest) * 1e3, device_ms=device_ms)

    # -- load introspection (the fleet's /healthz signals) ---------------

    def queue_rows(self) -> int:
        """Rows waiting in the coalescing queue now."""
        with self._lock:
            return self._pending_rows

    def latency_percentile(self, q: float) -> float:
        """Request-latency percentile (ms) over the batcher's lifetime
        histogram: the ``p99_ms`` health signal."""
        with self._stats:
            return self._lat.percentile(q)

    def fill_stats(self) -> Dict[str, Any]:
        """Cumulative micro-batch economics: batches, rows, bucket rows,
        pad rows and the fill and pad ratios derived from them."""
        with self._stats:
            c = dict(self.counters)
        return {
            "batches": c["batches"],
            "batch_rows": c["batch_rows"],
            "bucket_rows": c["bucket_rows"],
            "pad_rows": c["pad_rows"],
            "fill_rate": c["batch_rows"]
            / float(max(1, c["batches"] * self.max_batch)),
            "pad_fraction": c["pad_rows"]
            / float(max(1, c["bucket_rows"])),
        }

    # -- shutdown --------------------------------------------------------

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        """Stop intake; with ``drain`` run every queued request first,
        otherwise fail them with ServeClosedError. Joins both workers
        and returns the summary (also emitted as ``serve_summary``)."""
        failed = []
        with self._lock:
            self._closed = True
            if not drain:
                while self._pending:
                    req = self._pending.popleft()
                    self._pending_rows -= req.n
                    failed.append(req)
            self._wake.notify_all()
        for req in failed:
            with self._stats:
                self.counters["errors"] += 1
            self._emit_request("closed", req, 0.0)
            _set_exception(req.future,
                           ServeClosedError("server shut down"))
        self._collector.join(timeout)
        self._dispatcher.join(timeout)
        return self.summary(emit=True)

    def summary(self, emit: bool = False) -> Dict[str, Any]:
        with self._stats:
            c = dict(self.counters)
            p50 = self._lat.percentile(0.50)
            p99 = self._lat.percentile(0.99)
        bucket_rows = max(1, c["bucket_rows"])
        batch_cap = max(1, c["batches"] * self.max_batch)
        out = {
            "requests": c["requests"], "rows": c["rows"],
            "batches": c["batches"], "rejected": c["rejected"],
            "timeouts": c["timeouts"], "errors": c["errors"],
            "latency_p50_ms": round(p50, 3),
            "latency_p99_ms": round(p99, 3),
            "fill_rate": c["batch_rows"] / float(batch_cap),
            "pad_fraction": c["pad_rows"] / float(bucket_rows),
            "wall_s": time.monotonic() - self._t0,
        }
        if self._extra_summary is not None:
            # engine-side counters (compile events, AOT hit counts)
            # ride in the same summary record
            out.update(self._extra_summary())
        if emit:
            self._emit("serve_summary", **out)
        return out
