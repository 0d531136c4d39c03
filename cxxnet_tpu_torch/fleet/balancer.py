"""Front-of-fleet balancer: one address over N shared-nothing replicas
(counterpart of ``cxxnet_tpu/fleet/balancer.py``: the same routing,
retries, coalescing, canary pinning, endpoints and records).

The :class:`FleetBalancer` speaks both existing protocols (HTTP/JSON
and the CXN1 binary frames — the frame grammar and status vocabulary
are imported from ``serve/frontend.py``, so every existing client
works unchanged) and routes each request to a replica process:

- **load-aware health routing** — a poller thread reads every
  replica's enriched ``GET /healthz`` (queued rows, cumulative
  request/shed/error counters, p99, resident bytes) on a fixed
  cadence; request placement picks the ready, non-draining replica
  with the least (in-flight + queued) load. A replica that fails
  ``fleet_unhealthy_after`` consecutive polls — or any forward
  attempt at transport level — is routed around until a poll
  succeeds again.
- **idempotent retries** — ``predict`` is pure, so a transport
  failure (connection refused/reset, torn reply: the signature of a
  replica dying mid-request) retries the SAME rows on another replica,
  excluding the failed one. Losing a replica mid-traffic therefore
  drops **zero** requests (pinned by tests and the
  ``serve_bench --replicas`` kill scenario). A ``closed`` reply
  (replica draining) retries the same way; a ``busy`` reply retries
  once on a less-loaded replica before shedding.
- **fleet-wide tenant quotas** — the per-tenant token buckets
  (``serve_quota``/``serve_quota_default``) are enforced HERE, before
  any replica queue; replicas are spawned with quotas stripped so one
  tenant's contract is one bucket across the whole fleet, not N.
- **canary pinning** — ``pin_canary(version, fraction)`` routes a
  deterministic fraction of requests to replicas of that version;
  per-version outcome/latency windows feed the canary comparator
  (``fleet/canary.py``).
- **multiplexed data path** (the reference's doc/serving.md "Fleet data path") —
  forwards ride ``fleet_channels_per_replica`` persistent protocol-v2
  connections per replica (:class:`ReplicaChannel`: a writer queue +
  a reader thread resolving in-flight futures by correlation id), so
  per-replica concurrency is true pipelining over a handful of
  sockets instead of one blocking round trip per pooled connection.
  With ``fleet_coalesce_ms`` set, same-model requests merge into
  forwarded super-batches split by row offset on reply
  (:class:`_Coalescer`, completion-driven: idle traffic forwards
  immediately, load itself sets the batch size, the window is only
  the backstop); binary-path client row bytes relay into the forward
  frame as validated buffers — no decode→float32→re-encode on the
  hot path.

Every request emits a schema-validated ``fleet_route`` record
(replica, version, retries, coalesce/channel accounting); coalesced
forwards emit ``fleet_batch``; quota sheds also emit ``tenant_shed``.
"""

from __future__ import annotations

import http.client
import json
import math
import queue
import socket
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..monitor import LatencyHistogram, SafeEmitter
from ..serve.frontend import (_BinaryHandler, _FleetBinaryServer,
                              _FleetHTTPServer, _HttpHandler,
                              _REQ_HEADER_V2, BIN_MAGIC_V2,
                              HTTP_STATUS, BinaryClient, pack_ping_v2,
                              read_reply_tagged)
from ..serve.quota import TenantQuotaError
from .config import FleetTierConfig
from .quota_shares import QuotaShareManager


class ReplicaUnreachable(IOError):
    """Transport-level forward failure: the replica is gone or the
    connection died mid-exchange. Requests are idempotent, so the
    caller retries on another replica."""


class ReplicaV1Only(Exception):
    """The connect-time negotiation probe (a v2 ping) was answered
    with a v1 frame: the replica predates protocol v2. The balancer
    falls back to the pooled one-round-trip-per-connection path for
    it — old replicas keep working, just without pipelining."""


def _row_buffers(arr) -> Tuple[List[Any], int, int]:
    """``(buffers, nrows, elems)`` for relaying ``arr`` as a v2 frame
    payload. A C-contiguous little-endian float32 array — exactly what
    the binary ingress path hands through — is passed as ONE buffer
    view (zero-copy relay: the writer streams it straight onto the
    socket); anything else (the HTTP path's admission-converted rows)
    pays its one conversion here and never again."""
    a = np.ascontiguousarray(arr, dtype="<f4")
    if a.ndim == 1:
        a = a[None, :]
    nrows = int(a.shape[0])
    elems = int(a.size // nrows) if nrows else int(
        np.prod(a.shape[1:], dtype=np.int64)) or 1
    return [memoryview(a).cast("B")], nrows, elems


class _Inflight:
    __slots__ = ("future", "deadline")

    def __init__(self, window_s: float):
        self.future: Future = Future()
        self.deadline = time.monotonic() + window_s


class ReplicaChannel:
    """One persistent **multiplexed** v2 connection to a replica.

    Submitting threads enqueue framed requests on a writer queue and
    get a Future; a writer thread streams frames onto the socket
    (relaying client row buffers without re-encoding) and a reader
    thread resolves in-flight futures by correlation id as replies
    arrive — out of order, so a handful of sockets carry many
    concurrent requests with no head-of-line blocking (the reference's doc/serving.md
    "Fleet data path"). Any transport failure breaks the WHOLE
    channel: every in-flight future fails with
    :class:`ReplicaUnreachable` (requests are idempotent; callers
    retry elsewhere) and the owner reconnects lazily."""

    def __init__(self, host: str, port: int, index: int = 0,
                 connect_timeout: float = 5.0,
                 io_timeout: float = 3600.0):
        self.index = index
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout)
        # frames go out as header + body segments: without NODELAY,
        # Nagle holds the body for the replica's delayed ACK (~40ms
        # added to EVERY channel exchange)
        self._sock.setsockopt(socket.IPPROTO_TCP,
                              socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Inflight] = {}
        self._next_corr = 0
        self._broken: Optional[BaseException] = None
        self.max_depth = 0
        # negotiate: a v1-only server answers the v2 ping with a v1
        # bad_request frame (unknown magic) and drops the connection
        try:
            self._sock.sendall(pack_ping_v2(0))
            corr, _, _ = read_reply_tagged(self._rfile)
        except (OSError, ValueError) as e:
            self._close_sock()
            raise ReplicaUnreachable(
                "channel probe to %s:%d failed: %s" % (host, port, e))
        if corr is None:
            self._close_sock()
            raise ReplicaV1Only(
                "replica at %s:%d speaks protocol v1 only"
                % (host, port))
        self._sock.settimeout(io_timeout)
        self._send_lock = threading.Lock()
        self._wq: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(
            target=self._writer_loop, daemon=True,
            name="fleet-chan-w%d" % index)
        self._reader = threading.Thread(
            target=self._reader_loop, daemon=True,
            name="fleet-chan-r%d" % index)
        self._writer.start()
        self._reader.start()

    # -- submit side -------------------------------------------------------

    def submit(self, model: str, tenant: str, buffers: List[Any],
               nrows: int, elems: int, timeout_ms: float,
               window_s: float, blocking: bool = True) -> Future:
        """Frame one request; the Future resolves to
        ``(status_name, payload)`` or fails with ReplicaUnreachable.
        A ``blocking`` caller (a request handler thread that will wait
        on the future anyway) sends inline under the send lock — no
        thread hop; ``blocking=False`` (the coalescer's completion
        callbacks, which must never block a channel reader) rides the
        writer queue instead."""
        m, t = model.encode(), tenant.encode()
        if len(m) > 255 or len(t) > 255:
            raise ValueError(
                "model/tenant ids are limited to 255 bytes")
        ent = _Inflight(window_s)
        now = time.monotonic()
        with self._lock:
            if self._broken is not None:
                raise ReplicaUnreachable(
                    "channel broken: %s" % self._broken)
            # sweep entries whose waiter gave up long ago and whose
            # reply never came, so a wedged replica cannot grow the
            # map without bound
            stale = [c for c, e in self._inflight.items()
                     if now > e.deadline + 5.0]
            for c in stale:
                del self._inflight[c]
            self._next_corr += 1
            corr = self._next_corr
            self._inflight[corr] = ent
            depth = len(self._inflight)
            if depth > self.max_depth:
                self.max_depth = depth
        head = _REQ_HEADER_V2.pack(BIN_MAGIC_V2, corr, len(m), len(t),
                                   nrows, elems,
                                   float(timeout_ms or 0.0)) + m + t
        if not blocking:
            self._wq.put((head, buffers))
            return ent.future
        try:
            with self._send_lock:
                self._sock.sendall(head)
                for b in buffers:
                    self._sock.sendall(b)
        except OSError as e:
            self._break(e)
        return ent.future

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def broken(self) -> bool:
        with self._lock:
            return self._broken is not None

    # -- worker loops ------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            item = self._wq.get()
            if item is None:
                return
            head, buffers = item
            try:
                with self._send_lock:
                    self._sock.sendall(head)
                    for b in buffers:
                        self._sock.sendall(b)
            except OSError as e:
                self._break(e)
                return

    def _reader_loop(self) -> None:
        try:
            while True:
                try:
                    corr, status, payload = \
                        read_reply_tagged(self._rfile)
                except (OSError, ValueError) as e:
                    self._break(e)
                    return
                if corr is None:
                    self._break(IOError("v1 frame on a v2 channel"))
                    return
                with self._lock:
                    ent = self._inflight.pop(corr, None)
                if ent is None:
                    continue   # waiter expired and retried elsewhere
                if not ent.future.done():
                    try:
                        ent.future.set_result((status, payload))
                    except InvalidStateError:
                        pass  # cxxlint: disable=CXL006 -- the waiter cancelled first; the reply has no recipient
        finally:
            # the reader owns the buffered rfile: closing it from
            # another thread would deadlock on the buffer lock while
            # a read is parked in recv
            try:
                self._rfile.close()
            except OSError:
                pass  # cxxlint: disable=CXL006 -- teardown of a possibly-dead socket; there is nothing to do with a close error

    def _break(self, exc: BaseException) -> None:
        with self._lock:
            already = self._broken is not None
            if not already:
                self._broken = exc
            pending = list(self._inflight.values())
            self._inflight = {}
        if already and not pending:
            return
        err = ReplicaUnreachable("replica channel failed: %s" % exc)
        for ent in pending:
            if not ent.future.done():
                try:
                    ent.future.set_exception(err)
                except InvalidStateError:
                    pass  # cxxlint: disable=CXL006 -- the waiter cancelled first; nothing is owed an answer
        self._close_sock()
        self._wq.put(None)   # release the writer

    def _close_sock(self) -> None:
        # shutdown (not just close) unblocks a reader parked in recv;
        # the buffered rfile is closed by the reader thread itself —
        # closing it here would deadlock on its buffer lock
        for closer in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                       self._sock.close):
            try:
                closer()
            except OSError:
                pass  # cxxlint: disable=CXL006 -- teardown of a possibly-dead socket; there is nothing to do with a close error

    def close(self) -> None:
        self._break(IOError("channel closed"))


class ReplicaState:
    """Balancer-side view of one replica endpoint. ``inflight`` and
    the flags are guarded by the balancer's table lock; the connection
    pool has its own leaf lock (socket I/O must not hold the table
    lock)."""

    def __init__(self, replica_id: str, host: str, http_port: int,
                 binary_port: int, version: str,
                 kind: str = "baseline"):
        self.replica_id = replica_id
        self.host = host
        self.http_port = http_port
        self.binary_port = binary_port
        self.version = version
        self.kind = kind
        self.ready = True
        self.draining = False
        self.suspect = False
        self.suspect_since = 0.0
        self.fail_polls = 0
        self.inflight = 0
        self.health: Dict[str, Any] = {}
        # freshness + provenance of ``health``: a multi-balancer tier
        # partitions polling, so state may arrive from a peer's gossip
        # view instead of a direct poll
        self.health_ts = 0.0
        self.health_src = ""
        self.v1_only = False
        self._pool: List[BinaryClient] = []
        self._pool_lock = threading.Lock()
        self._channels: List[Optional[ReplicaChannel]] = []
        self._ch_rr = 0

    # -- multiplexed channels (protocol v2) -------------------------------

    def channel(self, nch: int,
                io_timeout: float) -> Optional[ReplicaChannel]:
        """Round-robin over up to ``nch`` persistent multiplexed
        channels, (re)connecting broken slots lazily. Returns None
        when the replica negotiated v1-only (caller falls back to the
        pooled path); raises :class:`ReplicaUnreachable` when the
        replica refuses the connection."""
        if self.v1_only or nch <= 0:
            return None
        with self._pool_lock:
            if len(self._channels) < nch:
                self._channels.extend(
                    [None] * (nch - len(self._channels)))
            self._ch_rr += 1
            i = self._ch_rr % nch
            ch = self._channels[i]
            if ch is not None and not ch.broken():
                return ch
            # connect under the leaf lock: localhost connects are
            # cheap, and a refused connect fails fast for everyone
            try:
                ch = ReplicaChannel(self.host, self.binary_port,
                                    index=i, io_timeout=io_timeout)
            except ReplicaV1Only:
                self.v1_only = True
                return None
            except OSError as e:
                raise ReplicaUnreachable(
                    "replica %s unreachable: %s"
                    % (self.replica_id, e))
            self._channels[i] = ch
            return ch

    def channel_depth(self) -> int:
        """In-flight requests across this replica's live channels —
        the pipelining-depth telemetry in the balancer window."""
        with self._pool_lock:
            chans = [c for c in self._channels if c is not None]
        return sum(c.depth() for c in chans if not c.broken())

    # -- connection pool (v1 fallback: one round trip per conn) ----------

    def acquire(self, timeout: float) -> BinaryClient:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return BinaryClient(self.host, self.binary_port,
                            timeout=timeout)

    def release(self, client: BinaryClient) -> None:
        with self._pool_lock:
            self._pool.append(client)

    def close_pool(self) -> None:
        with self._pool_lock:
            clients, self._pool = self._pool, []
            chans, self._channels = \
                [c for c in self._channels if c is not None], []
        for c in clients:
            try:
                c.close()
            except OSError:
                pass  # cxxlint: disable=CXL006 -- teardown of a possibly-dead socket; there is nothing to do with a close error
        for ch in chans:
            ch.close()

    def describe(self) -> Dict[str, Any]:
        return {"replica": self.replica_id, "version": self.version,
                "kind": self.kind, "ready": self.ready,
                "draining": self.draining, "suspect": self.suspect,
                "inflight": self.inflight,
                "queue_rows": self.health.get("queue_rows", 0),
                "p99_ms": self.health.get("p99_ms", 0.0),
                "resident_bytes": self.health.get("resident_bytes",
                                                  0)}


class _MergeJob:
    """One client request riding a coalesce window; the Future
    resolves to the full per-request outcome tuple
    ``(status, result, extra, replica_id, version, retries,
    coalesced, channel)``."""

    __slots__ = ("arr", "nrows", "timeout_ms", "future")

    def __init__(self, arr, nrows: int,
                 timeout_ms: Optional[float]):
        self.arr = arr
        self.nrows = nrows
        self.timeout_ms = timeout_ms
        self.future: Future = Future()


class _Coalescer:
    """Balancer-side request coalescing (``fleet_coalesce_ms``) —
    **completion-driven**: a request for an idle model forwards
    IMMEDIATELY (an unloaded fleet pays zero added latency); while
    forward slots (ready replicas x channels) are occupied, arriving
    requests queue, and each completing forward splits the queue
    EVENLY across the free slots as merged super-batches, split back
    by row offset on reply. Load itself sets the batch size — the serve
    dispatcher's economics applied one tier up, so single-row clients
    stop forcing a per-request forward (and its per-frame replica
    work) at high concurrency.

    ``fleet_coalesce_ms`` is the BACKSTOP: a queued window older than
    the window is force-flushed by the flusher thread even with every
    slot busy (a stalled forward must not become every request's
    wait), and ``fleet_coalesce_rows`` caps merged-batch size the
    same way. Forwarding is non-blocking
    (``FleetBalancer._forward_merged``), so one slow super-batch
    never delays the other models' queues."""

    def __init__(self, balancer: "FleetBalancer", window_s: float,
                 max_rows: int):
        self._bal = balancer
        self._window_s = window_s
        self._max_rows = max(1, int(max_rows))
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # (model_id, elems_per_row) -> [inflight_forwards,
        # window | None]; window = [t_open, jobs, rows]. Keying on
        # the row WIDTH too matters for correctness: a merged frame
        # declares one elems for all its row buffers, so requests of
        # different widths (one client's shape bug) must never share
        # a frame — each width bounces or succeeds on its own, like
        # the unmerged path
        self._st: Dict[Tuple[str, int], list] = {}
        self._closed = False
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="fleet-coalesce",
                                         daemon=True)
        self._flusher.start()

    def _cap(self) -> int:
        """Forward-slot bound per model: one outstanding super-batch
        per channel (ready replicas x channels) keeps every replica's
        pipeline fed — send of batch N+1 overlaps compute of batch N —
        while everything beyond that merges."""
        return max(1, self._bal._ready_count()
                   * max(1, self._bal.tier.channels_per_replica))

    def _split(self, st, force: bool = False) -> List[List[_MergeJob]]:
        """Cut the queued window into up-to-free-slot groups of
        roughly equal rows (each under ``fleet_coalesce_rows``) and
        claim their slots — called under the lock. Even groups matter:
        flushing the whole queue at one replica while freed slots
        idle gave a convoy (one giant batch + trailing singles) and
        its p99 with it."""
        jobs = st[1][1]
        st[1] = None
        free = self._cap() - st[0]
        if force and free < 1:
            free = 1
        total = sum(j.nrows for j in jobs)
        target = max(1, -(-total // max(1, free)))   # ceil
        target = min(target, self._max_rows)
        groups: List[List[_MergeJob]] = [[]]
        rows = 0
        for j in jobs:
            if rows >= target and groups[-1]:
                groups.append([])
                rows = 0
            groups[-1].append(j)
            rows += j.nrows
        st[0] += len(groups)
        return groups

    def _launch(self, key: Tuple[str, int],
                groups: List[List[_MergeJob]]) -> None:
        for jobs in groups:
            self._bal._forward_merged(
                key[0], jobs,
                on_done=lambda k=key: self._forward_done(k))

    def add(self, model_id: str, arr, nrows: int, elems: int,
            timeout_ms: Optional[float]) -> Future:
        job = _MergeJob(arr, nrows, timeout_ms)
        groups: List[List[_MergeJob]] = []
        key = (model_id, elems)
        with self._lock:
            if self._closed:
                job.future.set_result((
                    "closed", "balancer shutting down", {}, "", "",
                    0, 1, -1))
                return job.future
            st = self._st.setdefault(key, [0, None])
            if st[0] == 0 and st[1] is None:
                # idle model: forward NOW — coalescing adds zero
                # latency until there is actual load to merge
                st[0] = 1
                groups = [[job]]
            else:
                if st[1] is None:
                    st[1] = [time.monotonic(), [], 0]
                    self._wake.notify_all()  # new backstop deadline
                st[1][1].append(job)
                st[1][2] += nrows
                if st[1][2] >= self._max_rows \
                        and st[0] < self._cap():
                    groups = self._split(st)   # size cap: flush early
        self._launch(key, groups)
        return job.future

    def _forward_done(self, key: Tuple[str, int]) -> None:
        """One merged forward settled (any status): free its slot and
        flush the queue behind it across the free slots. Runs on a
        channel reader thread — submission is non-blocking."""
        groups: List[List[_MergeJob]] = []
        with self._lock:
            st = self._st.get(key)
            if st is None:
                return
            st[0] -= 1
            if st[1] is not None and st[0] < self._cap():
                groups = self._split(st)
            elif st[0] <= 0 and st[1] is None:
                del self._st[key]        # idle model: drop the entry
        self._launch(key, groups)

    def _flush_loop(self) -> None:
        """The backstop: force-flush windows older than the coalesce
        window even when every slot is busy (a stalled forward must
        not become every queued request's wait)."""
        while True:
            due = []
            with self._lock:
                while not self._closed:
                    now = time.monotonic()
                    deadline = min(
                        (st[1][0] + self._window_s
                         for st in self._st.values()
                         if st[1] is not None), default=None)
                    if deadline is not None and deadline <= now:
                        break
                    self._wake.wait(
                        None if deadline is None else deadline - now)
                now = time.monotonic()
                for key in list(self._st):
                    st = self._st[key]
                    if st[1] is not None and (
                            self._closed
                            or st[1][0] + self._window_s <= now):
                        due.append((key, self._split(st, force=True)))
                drained = self._closed and all(
                    st[1] is None for st in self._st.values())
            for key, groups in due:
                self._launch(key, groups)
            if drained:
                return

    def close(self) -> None:
        """Flush-forward everything still queued (zero-drop
        shutdown), then stop the flusher."""
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        self._flusher.join(timeout=30)


class _VersionStats:
    """Per-bundle-version outcome window (canary comparison)."""

    __slots__ = ("ok", "errors", "lat")

    def __init__(self):
        self.ok = 0
        self.errors = 0
        self.lat = LatencyHistogram()

    def snapshot(self) -> Dict[str, Any]:
        return {"ok": self.ok, "errors": self.errors,
                "requests": self.ok + self.errors,
                "p99_ms": round(self.lat.percentile(0.99), 3),
                "p50_ms": round(self.lat.percentile(0.50), 3)}


class FleetBalancer:
    """N replica endpoints behind the two protocol listeners.

    Build from the parsed tier config plus the raw config stream (for
    the quota grammar); ``start()`` binds listeners and the health
    poller, ``close()`` stops them. Replica registration is the
    controller's job (``add_replica`` / ``drain_replica`` /
    ``remove_replica``)."""

    # forward socket timeout: generous enough for a queued request on
    # a loaded replica, finite so a wedged replica turns into a
    # retryable transport error instead of a hung client
    FORWARD_TIMEOUT_S = 60.0
    # channel socket recv backstop: request-level failure is governed
    # by each waiter's forward window (result timeout -> retryable),
    # and a dead replica surfaces as EOF/RST — this only reclaims a
    # reader parked on a silently-blackholed connection, so it sits
    # far ABOVE any legitimate client deadline (a 120 s tripwire here
    # would break the channel, and every in-flight request with it,
    # under a declared-slow request)
    CHANNEL_IO_TIMEOUT_S = 3600.0

    def __init__(self, tier: FleetTierConfig, cfg=(), monitor=None):
        self.tier = tier
        self.balancer_id = tier.balancer_id
        self.balancer_index = tier.balancer_index
        # a share manager even at balancers=1: the single-door case is
        # bit-identical to the plain QuotaManager (pinned by test), so
        # every existing quota contract exercises the shared code path
        self.quota = QuotaShareManager(cfg,
                                       balancer_id=tier.balancer_id,
                                       balancers=tier.balancers)
        self._mon = monitor
        self._safe_emit = SafeEmitter(monitor, "cxxnet_tpu_torch fleet")
        self._lock = threading.Lock()        # replica table
        self._reps: Dict[str, ReplicaState] = {}
        self._stats = threading.Lock()       # counters + windows
        self.counters: Dict[str, int] = {
            "requests": 0, "ok": 0, "shed": 0, "errors": 0,
            "retries": 0, "unrouted": 0}
        self._win = {"requests": 0, "ok": 0, "shed": 0, "errors": 0,
                     "forwards": 0, "forward_requests": 0,
                     "forward_rows": 0}
        self._win_lat = LatencyHistogram()
        self._win_t0 = time.monotonic()
        self._versions: Dict[str, _VersionStats] = {}
        self._pin_version: Optional[str] = None
        self._pin_fraction = 0.0
        self._pick_seq = 0
        self._pick_rr = 0
        self._inflight_reqs = 0
        # intra-tier state: peer doors (balancer_id, host, http_port)
        # and their last gossip views (demand rates for rebalancing)
        self._peers: List[Tuple[str, str, int]] = []
        self._peer_views: Dict[str, Dict[str, Any]] = {}
        self._closing = False
        self._coal: Optional[_Coalescer] = None
        if tier.coalesce_ms > 0:
            self._coal = _Coalescer(self, tier.coalesce_ms / 1e3,
                                    tier.coalesce_rows)
        self._http_server = None
        self._binary_server = None
        self._threads: List[threading.Thread] = []
        self._poll_stop = threading.Event()
        self.http_port = -1
        self.binary_port = -1

    # -- replica table ----------------------------------------------------

    def add_replica(self, replica_id: str, host: str, http_port: int,
                    binary_port: int, version: str,
                    kind: str = "baseline") -> ReplicaState:
        rep = ReplicaState(replica_id, host, http_port, binary_port,
                           version, kind)
        with self._lock:
            if replica_id in self._reps:
                raise ValueError("replica %r already registered"
                                 % replica_id)
            self._reps[replica_id] = rep
        return rep

    def remove_replica(self, replica_id: str) -> None:
        with self._lock:
            rep = self._reps.pop(replica_id, None)
        if rep is not None:
            rep.close_pool()

    def has_replica(self, replica_id: str) -> bool:
        with self._lock:
            return replica_id in self._reps

    def set_replica_draining(self, replica_id: str,
                             draining: bool) -> bool:
        """Flip the draining flag (registry-driven; an external door
        learns drains from the controller's registry writes, not a
        direct call). Returns True when the flag changed."""
        with self._lock:
            rep = self._reps.get(replica_id)
            if rep is None or rep.draining == bool(draining):
                return False
            rep.draining = bool(draining)
            return True

    # -- intra-tier peers (sharded front tier) -----------------------------

    def set_tier_peers(self, peers: List[Tuple[str, str, int]]) -> bool:
        """The OTHER doors of this tier as ``(balancer_id, host,
        http_port)`` — gossip partners and the divisor of the poll
        partition. Returns True when the set changed."""
        peers = sorted(peers)
        with self._lock:
            if peers == self._peers:
                return False
            self._peers = peers
            live = {p[0] for p in peers}
            for bid in list(self._peer_views):
                if bid not in live:
                    del self._peer_views[bid]
            return True

    def tier_peers(self) -> List[Tuple[str, str, int]]:
        with self._lock:
            return list(self._peers)

    def drain_replica(self, replica_id: str,
                      timeout_s: float = 30.0) -> bool:
        """Stop routing new requests to the replica, then wait for its
        in-flight forwards to finish — the zero-drop half of scale-in.
        Returns False if in-flight work remained at the timeout."""
        with self._lock:
            rep = self._reps.get(replica_id)
            if rep is None:
                return True
            rep.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if rep.inflight == 0:
                    return True
            time.sleep(0.01)
        with self._lock:
            return rep.inflight == 0

    def suspect_overdue(self, deadline_s: float) -> List[str]:
        """Replicas that have been suspect (failing polls / transport)
        for longer than ``deadline_s`` — alive-but-wedged processes
        the controller must reap, or they would hold a fleet slot
        forever while serving nothing."""
        now = time.monotonic()
        with self._lock:
            return [r.replica_id for r in self._reps.values()
                    if r.suspect and r.suspect_since
                    and now - r.suspect_since >= deadline_s]

    def replica_ids(self, kind: Optional[str] = None,
                    version: Optional[str] = None) -> List[str]:
        with self._lock:
            return [r.replica_id for r in self._reps.values()
                    if (kind is None or r.kind == kind)
                    and (version is None or r.version == version)]

    def describe_replicas(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.describe() for r in self._reps.values()]

    # -- canary pinning ----------------------------------------------------

    def pin_canary(self, version: str, fraction: float) -> None:
        """Route ``fraction`` of requests to replicas serving
        ``version`` (deterministic interleave, no RNG: request k goes
        canary iff floor(k*f) advanced). Also resets the per-version
        windows so the comparison covers exactly the pinned period."""
        with self._stats:
            self._versions = {}
        with self._lock:
            self._pin_version = version
            self._pin_fraction = float(fraction)
            self._pick_seq = 0

    def unpin_canary(self) -> None:
        with self._lock:
            self._pin_version = None
            self._pin_fraction = 0.0

    def set_replica_kind(self, replica_id: str, kind: str) -> None:
        """Reclassify a replica (a promoted canary joins the baseline
        pool the autoscaler manages)."""
        with self._lock:
            rep = self._reps.get(replica_id)
            if rep is not None:
                rep.kind = kind

    def version_stats(self) -> Dict[str, Dict[str, Any]]:
        with self._stats:
            return {v: s.snapshot()
                    for v, s in self._versions.items()}

    # -- the request path --------------------------------------------------

    def handle(self, model_id: str, tenant: str, rows,
               protocol: str = "http",
               timeout_ms: Optional[float] = None
               ) -> Tuple[str, Any, Dict[str, Any]]:
        """Quota -> pick replica -> forward (with idempotent retry).
        Same contract as ``FleetServer.handle`` — never raises, so
        both protocol handlers plug in unchanged."""
        t0 = time.monotonic()
        nrows = 0
        replica_id, version, retries = "", "", 0
        coalesced, channel = 1, -1
        with self._stats:
            self._inflight_reqs += 1
        try:
            if isinstance(rows, np.ndarray) \
                    and rows.dtype == np.dtype("<f4") \
                    and rows.ndim >= 1 \
                    and rows.flags["C_CONTIGUOUS"]:
                arr = rows   # binary ingress: relay the bytes as-is
            else:
                # HTTP/JSON (or odd dtypes): ONE conversion here at
                # admission; everything downstream relays the buffer
                arr = np.asarray(rows, dtype=np.float32)  # cxxlint: disable=CXL003 -- protocol decode on the network tier: client rows arrive as host bytes/JSON lists, there is no device value to keep resident
            if arr.ndim == 0:
                raise ValueError("rows must be an array, got a scalar")
            nrows = int(arr.shape[0]) if arr.ndim > 1 else 1
            try:
                self.quota.admit(tenant, nrows)
            except TenantQuotaError as e:
                self._emit("tenant_shed", tenant=tenant,
                           model=model_id, rows=nrows, rate=e.rate,
                           burst=e.burst,
                           balancer=self.balancer_id,
                           retry_after_s=round(e.retry_after_s, 3))
                raise
            if self._coal is not None:
                elems = int(arr.size // nrows) if nrows else 0
                fut = self._coal.add(model_id, arr, nrows, elems,
                                     timeout_ms)
                window = (self.FORWARD_TIMEOUT_S
                          + self.tier.coalesce_ms / 1e3 + 10.0) \
                    * (self.tier.retries + 1)
                if timeout_ms:
                    window = max(window, timeout_ms / 1e3 + 10.0)
                try:
                    (status, result, extra, replica_id, version,
                     retries, coalesced, channel) = fut.result(window)
                except FutureTimeout:
                    status, result, extra = \
                        "error", "fleet forward timed out", {}
            else:
                (status, result, extra, replica_id, version, retries,
                 channel) = self._route(model_id, tenant, arr,
                                        timeout_ms)
        except TenantQuotaError as e:
            status, result = "over_quota", str(e)
            extra = {"retry_after_s": e.retry_after_s}
        except (ValueError, TypeError) as e:
            status, result, extra = "bad_request", str(e), {}
        except Exception as e:   # a balancer bug must answer, not hang
            status, result, extra = "error", str(e), {}
        finally:
            with self._stats:
                self._inflight_reqs -= 1
        self._record(protocol, status, model_id, tenant, nrows,
                     replica_id, version, retries, t0,
                     coalesced=coalesced, channel=channel)
        return status, result, extra

    def _route(self, model_id: str, tenant: str, arr: np.ndarray,
               timeout_ms: Optional[float]):
        excluded: set = set()
        retries = 0
        last: Optional[Tuple[str, Any, str, str]] = None
        for attempt in range(self.tier.retries + 1):
            rep = self._pick(excluded)
            if rep is None:
                break
            with self._lock:
                rep.inflight += 1
            try:
                status, result, channel = self._forward(
                    rep, model_id, tenant, arr, timeout_ms)
            except ReplicaUnreachable:
                # the replica died (or its socket did) mid-request:
                # mark it suspect so new requests route around it, and
                # retry these idempotent rows elsewhere
                self._mark_suspect(rep)
                excluded.add(rep.replica_id)
                retries += 1
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
            if status == "closed" and not self._closing:
                # replica draining/shut down between pick and forward
                excluded.add(rep.replica_id)
                retries += 1
                last = (status, result, rep.replica_id, rep.version)
                continue
            if status == "busy" and attempt == 0 \
                    and self._ready_count() > 1:
                # one overloaded replica is not fleet overload: give a
                # less-loaded replica one chance before shedding
                excluded.add(rep.replica_id)
                retries += 1
                last = (status, result, rep.replica_id, rep.version)
                continue
            self._note_forward(1, int(arr.shape[0]) if arr.ndim > 1
                               else 1)
            return status, result, {}, rep.replica_id, rep.version, \
                retries, channel
        if last is not None:
            status, result, rid, ver = last
            return status, result, {}, rid, ver, retries, -1
        with self._stats:
            self.counters["unrouted"] += 1
        return ("closed", "no ready replicas", {}, "", "", retries, -1)

    def _mark_suspect(self, rep: ReplicaState) -> None:
        with self._lock:
            if not rep.suspect:
                rep.suspect = True
                rep.suspect_since = time.monotonic()

    def _note_forward(self, requests: int, rows: int) -> None:
        with self._stats:
            self._win["forwards"] += 1
            self._win["forward_requests"] += requests
            self._win["forward_rows"] += rows

    def _ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._reps.values()
                       if r.ready and not r.draining
                       and not r.suspect)

    def _pick(self, excluded: set) -> Optional[ReplicaState]:
        """Least-loaded ready replica (in-flight forwards + last
        polled queue depth), honoring the canary pin."""
        with self._lock:
            cands = [r for r in self._reps.values()
                     if r.ready and not r.draining and not r.suspect
                     and r.replica_id not in excluded]
            if not cands:
                # desperation pass: every healthy replica is excluded
                # or suspect — a suspect replica may have recovered,
                # and answering beats returning "no replicas"
                cands = [r for r in self._reps.values()
                         if r.ready and not r.draining
                         and r.replica_id not in excluded]
            if not cands:
                return None
            if self._pin_version is not None:
                self._pick_seq += 1
                f = self._pin_fraction
                want_canary = (math.floor(self._pick_seq * f)
                               > math.floor((self._pick_seq - 1) * f))
                pool = [r for r in cands
                        if (r.version == self._pin_version)
                        == want_canary]
                if pool:
                    cands = pool
            # rotating tiebreak: breaking load ties by replica_id
            # biased ALL cold-start and equal-load traffic onto the
            # lexicographically-first replica — rotate instead, so an
            # idle fleet spreads evenly (pinned by test)
            load = min(r.inflight + r.health.get("queue_rows", 0)
                       for r in cands)
            ties = [r for r in cands
                    if r.inflight + r.health.get("queue_rows", 0)
                    == load]
            self._pick_rr += 1
            return ties[self._pick_rr % len(ties)]

    def _forward_window(self, timeout_ms: Optional[float]) -> float:
        # a client that declared a deadline LONGER than the default
        # forward timeout gets the wait window to match — otherwise
        # a legitimately slow request could never succeed through the
        # balancer and would burn duplicate device work via retries
        window = self.FORWARD_TIMEOUT_S
        if timeout_ms:
            window = max(window, timeout_ms / 1e3 + 5.0)
        return window

    def _forward(self, rep: ReplicaState, model_id: str, tenant: str,
                 arr: np.ndarray, timeout_ms: Optional[float]
                 ) -> Tuple[str, Any, int]:
        """One exchange with the replica: a pipelined submit on a
        multiplexed channel (protocol v2), or — for a v1-only replica
        or ``fleet_channels_per_replica = 0`` — a blocking round trip
        on a pooled connection. Any transport/framing failure raises
        :class:`ReplicaUnreachable`. Returns (status, result,
        channel_index); -1 = pooled."""
        window = self._forward_window(timeout_ms)
        ch = rep.channel(self.tier.channels_per_replica,
                         self.CHANNEL_IO_TIMEOUT_S)
        if ch is None:
            status, result = self._forward_pooled(
                rep, model_id, tenant, arr, timeout_ms, window)
            return status, result, -1
        buffers, nrows, elems = _row_buffers(arr)
        fut = ch.submit(model_id, tenant, buffers, nrows, elems,
                        timeout_ms or 0.0, window)
        try:
            status, result = fut.result(timeout=window)
        except ReplicaUnreachable:
            raise
        except FutureTimeout:
            raise ReplicaUnreachable(
                "replica %s did not answer within %.0fs"
                % (rep.replica_id, window))
        return status, result, ch.index

    def _forward_pooled(self, rep: ReplicaState, model_id: str,
                        tenant: str, arr: np.ndarray,
                        timeout_ms: Optional[float],
                        sock_timeout: float) -> Tuple[str, Any]:
        """The v1 fallback: one blocking binary round trip over a
        pooled persistent connection."""
        try:
            client = rep.acquire(sock_timeout)
        except OSError as e:
            raise ReplicaUnreachable(
                "replica %s unreachable: %s" % (rep.replica_id, e))
        ok = False
        try:
            client.sock.settimeout(sock_timeout)
            status, result = client.predict(
                arr, model=model_id, tenant=tenant,
                timeout_ms=timeout_ms if timeout_ms else 0.0)
            ok = True
        except OSError as e:
            raise ReplicaUnreachable(
                "replica %s failed mid-request: %s"
                % (rep.replica_id, e))
        finally:
            # release-or-discard: EVERY exit returns the connection to
            # the pool or closes it. A non-OSError escaping predict
            # (e.g. a protocol ValueError from a malformed reply) used
            # to skip both — permanently losing the pool slot AND
            # leaking the socket (pinned by test)
            if ok:
                rep.release(client)
            else:
                try:
                    client.close()
                except OSError:
                    pass  # cxxlint: disable=CXL006 -- the transport already failed; close is best-effort cleanup
        return status, result

    # -- coalesced forwarding (fleet_coalesce_ms) --------------------------

    def _forward_merged(self, model_id: str, jobs: List[_MergeJob],
                        excluded: Optional[set] = None,
                        retries: int = 0,
                        last: Optional[Tuple] = None,
                        on_done=None) -> None:
        """Forward one merged super-batch, NON-blocking: completion
        (split, retry, shed) continues on the answering channel's
        reader thread, then calls ``on_done`` exactly once (the
        coalescer's slot-free hook). Retry and busy semantics apply
        to the WHOLE merged batch — the rows are idempotent together,
        so a replica loss retries them together and a kill
        mid-traffic drops zero and duplicates zero of them (pinned by
        test)."""
        excluded = set() if excluded is None else excluded
        rep = self._pick(excluded)
        if rep is None:
            if last is not None:
                status, result, rid, ver = last
            else:
                status, result, rid, ver = \
                    "closed", "no ready replicas", "", ""
                with self._stats:
                    self.counters["unrouted"] += len(jobs)
            self._resolve_merged(jobs, status, result, {}, rid, ver,
                                 retries, -1, on_done)
            return
        nrows = sum(j.nrows for j in jobs)
        timeout_ms = max((j.timeout_ms or 0.0 for j in jobs),
                         default=0.0)
        window = self._forward_window(timeout_ms)
        with self._lock:
            rep.inflight += 1
        t_fwd = time.monotonic()

        def transport_failed(exc):
            with self._lock:
                rep.inflight -= 1
            self._mark_suspect(rep)
            excluded.add(rep.replica_id)
            if retries < self.tier.retries:
                self._forward_merged(model_id, jobs, excluded,
                                     retries + 1, last, on_done)
            else:
                with self._stats:
                    self.counters["unrouted"] += len(jobs)
                self._resolve_merged(jobs, "closed",
                                     "no ready replicas", {}, "", "",
                                     retries + 1, -1, on_done)

        try:
            # merged forwards carry tenant "" — members may belong to
            # different tenants, and quota is a FLEET-WIDE contract
            # enforced at this balancer before merging (replicas are
            # spawned quota-stripped, the reference's doc/serving.md); a replica that
            # still enforces its own per-tenant quotas must not be
            # fronted with coalescing on
            ch = rep.channel(self.tier.channels_per_replica,
                             self.CHANNEL_IO_TIMEOUT_S)
            if ch is None:
                # v1-only replica: one blocking pooled round trip with
                # the members concatenated (the rare compat path)
                merged = np.concatenate(
                    [np.ascontiguousarray(j.arr, dtype="<f4").reshape(
                        j.nrows, -1) for j in jobs])
                status, result = self._forward_pooled(
                    rep, model_id, "", merged, timeout_ms, window)
                self._merged_reply(model_id, jobs, rep, -1, status,
                                   result, excluded, retries, last,
                                   t_fwd, nrows, on_done)
                return
            buffers = []
            elems = 0
            for j in jobs:
                bufs, _, elems = _row_buffers(j.arr)
                buffers.extend(bufs)
            fut = ch.submit(model_id, "", buffers, nrows, elems,
                            timeout_ms, window, blocking=False)
        except ReplicaUnreachable as e:
            transport_failed(e)
            return
        except Exception as e:
            with self._lock:
                rep.inflight -= 1
            self._resolve_merged(jobs, "error", str(e), {},
                                 rep.replica_id, rep.version, retries,
                                 -1, on_done)
            return

        def _done(f):
            exc = f.exception()
            if exc is not None:
                transport_failed(exc)
                return
            status, result = f.result()
            self._merged_reply(model_id, jobs, rep, ch.index, status,
                               result, excluded, retries, last, t_fwd,
                               nrows, on_done)

        fut.add_done_callback(_done)

    def _merged_reply(self, model_id, jobs, rep, channel, status,
                      result, excluded, retries, last, t_fwd,
                      nrows, on_done) -> None:
        """Classify one merged forward's reply: retry (closed/busy,
        whole batch) or resolve every member."""
        with self._lock:
            rep.inflight -= 1
        if status == "closed" and not self._closing \
                and retries < self.tier.retries:
            excluded.add(rep.replica_id)
            self._forward_merged(
                model_id, jobs, excluded, retries + 1,
                (status, result, rep.replica_id, rep.version),
                on_done)
            return
        if status == "busy" and retries == 0 \
                and self._ready_count() > 1:
            excluded.add(rep.replica_id)
            self._forward_merged(
                model_id, jobs, excluded, retries + 1,
                (status, result, rep.replica_id, rep.version),
                on_done)
            return
        self._note_forward(len(jobs), nrows)
        self._emit("fleet_batch", model=model_id,
                   replica=rep.replica_id, status=status,
                   requests=len(jobs), rows=nrows, channel=channel,
                   retries=retries, balancer=self.balancer_id,
                   latency_ms=(time.monotonic() - t_fwd) * 1e3)
        self._resolve_merged(jobs, status, result, {},
                             rep.replica_id, rep.version, retries,
                             channel, on_done)

    def _resolve_merged(self, jobs, status, result, extra, rid, ver,
                        retries, channel, on_done=None) -> None:
        """Split an ok super-batch reply by row offsets; any other
        status fans out to every member unchanged. Frees the
        coalescer slot FIRST so the next queued super-batch overlaps
        with the member futures waking their waiters."""
        if on_done is not None:
            on_done()
        coalesced = len(jobs)
        if status == "ok":
            total = sum(j.nrows for j in jobs)
            # an ok reply's payload is already the decoded row array
            # (np.frombuffer view on the channel reader) — no re-copy
            out = result
            if out.shape[0] != total:
                status, result = "error", (
                    "replica answered %d rows for %d sent"
                    % (out.shape[0], total))
            else:
                offset = 0
                for j in jobs:
                    rows = out[offset:offset + j.nrows]
                    offset += j.nrows
                    if not j.future.done():
                        j.future.set_result((
                            "ok", rows, extra, rid, ver, retries,
                            coalesced, channel))
                return
        for j in jobs:
            if not j.future.done():
                j.future.set_result((status, result, extra, rid, ver,
                                     retries, coalesced, channel))

    # -- telemetry / accounting -------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        self._safe_emit(kind, **fields)

    def _record(self, protocol: str, status: str, model: str,
                tenant: str, rows: int, replica_id: str, version: str,
                retries: int, t0: float, coalesced: int = 1,
                channel: int = -1) -> None:
        latency_s = time.monotonic() - t0
        shed = status in ("busy", "over_quota")
        with self._stats:
            self.counters["requests"] += 1
            self.counters["retries"] += retries
            self._win["requests"] += 1
            if status == "ok":
                self.counters["ok"] += 1
                self._win["ok"] += 1
                self._win_lat.observe(latency_s)
            elif shed:
                self.counters["shed"] += 1
                self._win["shed"] += 1
            else:
                self.counters["errors"] += 1
                self._win["errors"] += 1
            if version:
                vs = self._versions.get(version)
                if vs is None:
                    vs = self._versions[version] = _VersionStats()
                if status == "ok":
                    vs.ok += 1
                    vs.lat.observe(latency_s)
                elif not shed:
                    vs.errors += 1
        self._emit("fleet_route", protocol=protocol, status=status,
                   model=model, tenant=tenant, rows=rows,
                   replica=replica_id, version=version,
                   retries=retries, latency_ms=latency_s * 1e3,
                   coalesced=coalesced, channel=channel,
                   balancer=self.balancer_id)

    def take_window(self) -> Dict[str, Any]:
        """Counters since the last call plus the CURRENT fleet load —
        the autoscaler's input. Swapping the window out keeps rates
        honest without unbounded history."""
        now = time.monotonic()
        with self._stats:
            w = self._win
            lat = self._win_lat
            self._win = {"requests": 0, "ok": 0, "shed": 0,
                         "errors": 0, "forwards": 0,
                         "forward_requests": 0, "forward_rows": 0}
            self._win_lat = LatencyHistogram()
            t0, self._win_t0 = self._win_t0, now
        with self._lock:
            ready = [r for r in self._reps.values()
                     if r.ready and not r.draining and not r.suspect]
            queue_rows = sum(r.health.get("queue_rows", 0)
                             for r in ready)
            max_batch = max(
                (m.get("max_batch", 0)
                 for r in ready
                 for m in r.health.get("model_health", [])),
                default=0)
            total = len(self._reps)
        return {
            "requests": w["requests"], "ok": w["ok"],
            "shed": w["shed"], "errors": w["errors"],
            "p99_ms": round(lat.percentile(0.99), 3),
            "queue_rows": queue_rows, "max_batch": max_batch,
            "ready": len(ready), "replicas": total,
            "window_s": now - t0,
            # data-path health (the reference's doc/serving.md "Fleet data path"):
            # pipelining depth across the multiplexed channels right
            # now, and how well the coalescer merged this window
            "channel_depth": sum(r.channel_depth() for r in ready),
            "forwards": w["forwards"],
            "coalesce_fill": round(
                w["forward_requests"] / w["forwards"], 3)
            if w["forwards"] else 0.0,
        }

    # -- health polling ----------------------------------------------------

    def _poll_once(self, rep: ReplicaState) -> None:
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.http_port,
                timeout=max(1.0, self.tier.health_poll_s * 4))
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                ok = resp.status == 200 and payload.get("ok")
            finally:
                conn.close()
        except (OSError, ValueError):
            ok, payload = False, None
        with self._lock:
            if ok:
                rep.health = payload
                rep.health_ts = time.monotonic()
                rep.health_src = "poll"
                rep.fail_polls = 0
                rep.suspect = False
                rep.suspect_since = 0.0
            else:
                rep.fail_polls += 1
                if rep.fail_polls >= self.tier.unhealthy_after \
                        and not rep.suspect:
                    rep.suspect = True
                    rep.suspect_since = time.monotonic()

    def _poll_targets(self) -> List[ReplicaState]:
        """The replicas THIS door polls: with N doors, replica i (in
        sorted id order) belongs to door ``i % N`` — tier health costs
        one poll per replica per period, not N. A replica whose state
        has gone stale (its owner door died, or gossip is broken)
        falls back to a direct poll from everyone: correctness first,
        amplification second."""
        with self._lock:
            reps = sorted(self._reps.values(),
                          key=lambda r: r.replica_id)
            npeers = len(self._peers)
        if not npeers:
            return reps
        n = npeers + 1
        stale_after = max(2 * self.tier.gossip_s,
                          4 * self.tier.health_poll_s)
        now = time.monotonic()
        return [rep for i, rep in enumerate(reps)
                if i % n == self.balancer_index % n
                or now - rep.health_ts > stale_after]

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.tier.health_poll_s):
            for rep in self._poll_targets():
                self._poll_once(rep)

    # -- intra-tier gossip (sharded front tier) ----------------------------

    def view_snapshot(self) -> Dict[str, Any]:
        """``GET /fleet/view``: what this door KNOWS first-hand — the
        health of the replicas it polled itself (``age_s`` relative,
        monotonic clocks don't compare across processes) plus its own
        demand rates. Gossip-learned state is excluded so a view never
        echoes another door's data back as fresh."""
        now = time.monotonic()
        reps: Dict[str, Any] = {}
        with self._lock:
            for r in self._reps.values():
                if r.health_src != "poll" or not r.health_ts:
                    continue
                reps[r.replica_id] = {
                    "health": r.health, "suspect": r.suspect,
                    "age_s": round(now - r.health_ts, 3)}
        return {"balancer": self.balancer_id,
                "index": self.balancer_index,
                "replicas": reps,
                "demand": self.quota.demand_view(),
                "inflight": self._inflight_snapshot()}

    def merge_view(self, view: Dict[str, Any]) -> None:
        """Fold one peer's ``/fleet/view`` into the local tables:
        newer replica health wins (by age), and the peer's demand
        rates feed the next quota rebalance."""
        bid = str(view.get("balancer", ""))
        if not bid:
            return
        now = time.monotonic()
        with self._lock:
            self._peer_views[bid] = {
                "ts": now,
                "demand": {str(t): float(r) for t, r in
                           dict(view.get("demand", {})).items()}}
            for rid, info in dict(view.get("replicas", {})).items():
                rep = self._reps.get(rid)
                if rep is None:
                    continue
                ts = now - float(info.get("age_s", 0.0))
                if ts <= rep.health_ts:
                    continue          # our own information is newer
                health = info.get("health")
                if health:
                    rep.health = dict(health)
                rep.health_ts = ts
                rep.health_src = "gossip"
                suspect = bool(info.get("suspect", False))
                if suspect and not rep.suspect:
                    rep.suspect = True
                    rep.suspect_since = now
                elif not suspect and rep.suspect:
                    rep.suspect = False
                    rep.suspect_since = 0.0
                    rep.fail_polls = 0

    def _fetch_peer_view(self, host: str, port: int
                         ) -> Optional[Dict[str, Any]]:
        try:
            conn = http.client.HTTPConnection(
                host, port, timeout=max(1.0, self.tier.gossip_s * 4))
            try:
                conn.request("GET", "/fleet/view")
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return None

    def _gossip_loop(self) -> None:
        next_rebalance = time.monotonic() \
            + self.tier.quota_rebalance_s
        while not self._poll_stop.wait(self.tier.gossip_s):
            for bid, host, port in self.tier_peers():
                view = self._fetch_peer_view(host, port)
                if view is not None:
                    self.merge_view(view)
            if time.monotonic() >= next_rebalance:
                self._rebalance_quota()
                next_rebalance = time.monotonic() \
                    + self.tier.quota_rebalance_s

    def _rebalance_quota(self) -> None:
        """Close this door's demand window and recompute its share
        fractions from the merged per-door demand views."""
        views = {self.balancer_id: self.quota.sample_demand()}
        with self._lock:
            for bid, pv in self._peer_views.items():
                views[bid] = dict(pv.get("demand", {}))
        changed = self.quota.rebalance(views)
        if changed:
            self._emit(
                "quota_rebalance", balancer=self.balancer_id,
                tenants=len(changed),
                window_s=round(self.tier.quota_rebalance_s, 3),
                shares={t: round(f, 4) for t, f in changed.items()})

    # -- own health / status ----------------------------------------------

    def _inflight_snapshot(self) -> int:
        with self._stats:
            return self._inflight_reqs

    def health_snapshot(self) -> Dict[str, Any]:
        with self._stats:
            c = dict(self.counters)
            inflight = self._inflight_reqs
        reps = self.describe_replicas()
        ready = sum(1 for r in reps
                    if r["ready"] and not r["draining"]
                    and not r["suspect"])
        with self._lock:
            pin = {"version": self._pin_version,
                   "fraction": self._pin_fraction} \
                if self._pin_version else None
            npeers = len(self._peers)
            rep_states = list(self._reps.values())
        chan_depth = sum(r.channel_depth() for r in rep_states)
        return {"ok": ready > 0, "tier": "balancer",
                "balancer": self.balancer_id,
                "balancers": npeers + 1,
                "ready": ready, "replicas": reps,
                "requests": c["requests"], "shed": c["shed"],
                "errors": c["errors"], "retries": c["retries"],
                "canary": pin,
                # self-report: this door's OWN load, uniform with the
                # replica tier's /healthz so serve_bench and the
                # controller read both tiers the same way
                "inflight": inflight,
                "channel_depth": chan_depth,
                "quota_shares": self.quota.share_snapshot(),
                "queue_rows": sum(r["queue_rows"] for r in reps),
                "resident_bytes": sum(r["resident_bytes"]
                                      for r in reps)}

    def models_snapshot(self) -> Dict[str, Any]:
        """``GET /v1/models`` at the balancer: the model table proxied
        from one ready replica (they all serve the same contract),
        annotated with the per-version replica split."""
        with self._lock:
            cands = [r for r in self._reps.values()
                     if r.ready and not r.suspect]
        models: List[Dict[str, Any]] = []
        for rep in cands:
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.http_port, timeout=5.0)
                try:
                    conn.request("GET", "/v1/models")
                    resp = conn.getresponse()
                    if resp.status == 200:
                        models = json.loads(resp.read())["models"]
                        break
                finally:
                    conn.close()
            except (OSError, ValueError):
                continue          # a dead replica: try the next one
        versions: Dict[str, int] = {}
        with self._lock:
            for r in self._reps.values():
                versions[r.version] = versions.get(r.version, 0) + 1
        return {"models": models, "replica_versions": versions}

    # -- listeners ---------------------------------------------------------

    def start(self) -> None:
        t = self.tier
        if t.http_port >= 0:
            self._http_server = _FleetHTTPServer(
                (t.host, t.http_port), _BalancerHttpHandler, self)
            self.http_port = self._http_server.server_address[1]
            th = threading.Thread(
                target=self._http_server.serve_forever,
                name="fleet-http", daemon=True)
            th.start()
            self._threads.append(th)
        if t.binary_port >= 0:
            self._binary_server = _FleetBinaryServer(
                (t.host, t.binary_port), _BinaryHandler, self)
            self.binary_port = self._binary_server.server_address[1]
            th = threading.Thread(
                target=self._binary_server.serve_forever,
                name="fleet-binary", daemon=True)
            th.start()
            self._threads.append(th)
        poller = threading.Thread(target=self._poll_loop,
                                  name="fleet-health", daemon=True)
        poller.start()
        self._threads.append(poller)
        if t.balancers > 1:
            gossiper = threading.Thread(target=self._gossip_loop,
                                        name="fleet-gossip",
                                        daemon=True)
            gossiper.start()
            self._threads.append(gossiper)

    def close(self) -> Dict[str, Any]:
        self._closing = True
        if self._coal is not None:
            self._coal.close()   # flush-forward anything windowed
        self._poll_stop.set()
        for srv in (self._http_server, self._binary_server):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        for th in self._threads:
            th.join(timeout=30)
        with self._lock:
            reps = list(self._reps.values())
            self._reps = {}
        for rep in reps:
            rep.close_pool()
        with self._stats:
            return dict(self.counters)


# -- balancer HTTP protocol ------------------------------------------------
#
# Reuses the fleet front end's JSON plumbing (_send_json, keep-alive,
# no access log); only the introspection payloads differ — requests go
# through FleetBalancer.handle, which shares FleetServer.handle's
# contract, so the POST body/reply grammar is identical on purpose.


class _BalancerHttpHandler(_HttpHandler):

    def do_GET(self):
        bal = self.server.fleet
        if self.path == "/healthz":
            self._send_json(200, bal.health_snapshot())
        elif self.path == "/v1/models":
            self._send_json(200, bal.models_snapshot())
        elif self.path == "/fleet/view":
            # intra-tier gossip: peers fetch this door's first-hand
            # replica health + demand rates (non-destructive)
            self._send_json(200, bal.view_snapshot())
        elif self.path == "/fleet/window":
            # DESTRUCTIVE window read for the controller's autoscale
            # aggregation — one caller per door, by contract
            self._send_json(200, bal.take_window())
        else:
            self._send_json(404, {"error": "not_found",
                                  "message": "unknown path %r"
                                  % self.path})

    def do_POST(self):
        bal = self.server.fleet
        if self.path != "/v1/predict":
            self._send_json(404, {"error": "not_found",
                                  "message": "POST /v1/predict"})
            return
        t0 = time.monotonic()
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            model = str(req.get("model", ""))
            tenant = str(req.get("tenant", ""))
            timeout_ms = req.get("timeout_ms")
            rows = req["rows"]
        except (ValueError, KeyError, TypeError) as e:
            bal._record("http", "bad_request", "", "", 0, "", "", 0,
                        t0, coalesced=0, channel=-1)
            self._send_json(400, {"error": "bad_request",
                                  "message": "body must be JSON with "
                                  "'rows': %s" % e})
            return
        status, result, extra = bal.handle(
            model, tenant, rows, protocol="http",
            timeout_ms=timeout_ms)
        code = HTTP_STATUS[status]
        if status == "ok":
            flat = np.asarray(result)
            self._send_json(code, {
                "model": model,
                "rows": int(flat.shape[0]),
                "result": flat.reshape(flat.shape[0], -1).tolist()})
            return
        headers = {}
        if status in ("busy", "over_quota"):
            headers["Retry-After"] = "%d" % max(
                1, int(extra.get("retry_after_s", 1) + 0.999))
        self._send_json(code, dict(
            {"error": status, "message": result}, **extra),
            headers=headers)
