"""Fleet front end: network protocols over the serve subsystem
(counterpart of ``cxxnet_tpu/serve/frontend.py``: the same frames,
status codes, JSON bodies and config keys, byte for byte).

``FleetServer`` turns N :class:`~cxxnet_tpu_torch.serve.server.
ServeSession` engines into one deployable service (``task =
serve_fleet``; the reference's doc/serving.md):

- **two protocols, one core** — an HTTP/JSON endpoint for
  debuggability (curl-able, self-describing errors) and a
  length-prefixed binary protocol for raw float rows (no JSON
  float-printing cost on the hot path). Both funnel into
  :meth:`FleetServer.handle`, so routing, quotas, shedding and
  telemetry behave identically.
- **multi-model routing** — requests name a model id; the
  :class:`~cxxnet_tpu_torch.serve.router.ModelRouter` resolves it to the
  live engine (each with its own bucket ladder and drain lifecycle).
- **tenant quotas** — every request passes the
  :class:`~cxxnet_tpu_torch.serve.quota.QuotaManager` *before* touching the
  shared dispatcher queue; an over-quota tenant is shed with a typed
  429-style reply (``over_quota``, Retry-After) instead of queueing
  into everyone's p99. Dispatcher backpressure
  (:class:`~cxxnet_tpu_torch.serve.batcher.ServeBusyError`) and deadlines
  (``ServeTimeoutError``) map to ``busy`` (429) and ``timeout`` (504)
  the same way.
- **zero-downtime hot-swap** — a
  :class:`~cxxnet_tpu_torch.serve.swap.SnapshotWatcher` per model polls its
  ``model_dir`` for newer *verified* snapshots and sealed bundles, warms
  a shadow engine,
  flips the router entry, drains the old engine. The front end retries
  the one unclosable race (``ServeClosedError`` from a session that
  was flipped away mid-request) through a fresh resolve, so a swap
  never fails a request.

Every request emits a schema-validated ``serve_http`` record; quota
sheds additionally emit ``tenant_shed``; swaps emit ``hot_swap``.

The sessions run on the GPU unless the config says ``dev = cpu`` (or
the caller passes ``device``). A model booted from a bundle that seals
an embedding index answers the retrieval operations through its
session's :class:`~cxxnet_tpu_torch.retrieval.engine.RetrievalEngine`:
``model#search[:k]`` and ``POST /v1/search`` take query vectors,
``model#fsearch[:k]`` and ``/v1/search`` with ``fan_out = 1`` take model
inputs (embed, then search, on one resolved session, so a hot-swap
never pairs one generation's embedding with the other's corpus), and
``model#embed`` and ``POST /v1/embed`` are predict. A model without an
index answers a search with ``bad_request``, in the reference's words.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import socketserver
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..artifact.bundle import is_bundle
from ..artifact.fingerprint import fingerprint_sha, runtime_fingerprint
from ..device import named_device, resolve_device
from ..monitor import SafeEmitter
from ..utils.stream import stream_exists
from .batcher import (ServeBusyError, ServeClosedError,
                      ServeTimeoutError)
from .quota import QuotaManager, TenantQuotaError
from .router import ModelRouter, UnknownModelError
from .server import ServeSession
from .swap import SnapshotWatcher, counter_of, latest_verified

# -- binary protocol ------------------------------------------------------
#
# v1 (untagged, one round trip per in-flight request):
# Request:  MAGIC | u8 model_len | u8 tenant_len | u32 nrows |
#           u32 elems_per_row | f32 timeout_ms | model utf8 |
#           tenant utf8 | nrows*elems float32 LE rows
# Reply:    MAGIC | u8 status | u32 nrows | u32 elems_per_row |
#           payload: float32 LE rows (status 0) or
#           u32 msg_len + utf8 message (any other status)
#
# v2 (correlated, multiplexed): the same grammar under the CXN2 magic
# with a u32 correlation id after the magic on both frames. Replies
# carry the request's id and MAY arrive out of order, so one
# persistent connection pipelines many in-flight requests (the fleet
# balancer's ReplicaChannel; the reference's doc/serving.md "Fleet data
# path").
# Negotiation is per-frame and stateless: a v2 frame gets a v2 reply,
# an untagged v1 frame gets a v1 reply — old clients keep working
# unchanged. A v2 request with nrows == elems == model_len ==
# tenant_len == 0 is a PING: answered ok (0 rows) without touching
# the request core — the connect-time probe a v2 client uses to
# detect a v1-only server (which answers the unknown magic with a v1
# bad_request frame and drops the connection).

BIN_MAGIC = b"CXN1"
BIN_MAGIC_V2 = b"CXN2"
_REQ_HEADER = struct.Struct("<4sBBIIf")
_REP_HEADER = struct.Struct("<4sBII")
_REQ_HEADER_V2 = struct.Struct("<4sIBBIIf")
_REP_HEADER_V2 = struct.Struct("<4sIBII")
_MSG_LEN = struct.Struct("<I")

# hard sanity caps on a single binary frame: a corrupt length prefix
# must fail the frame, not allocate gigabytes
MAX_FRAME_ROWS = 1 << 20
MAX_FRAME_BYTES = 256 << 20

STATUS_OK = 0
STATUS_BUSY = 1
STATUS_OVER_QUOTA = 2
STATUS_TIMEOUT = 3
STATUS_UNKNOWN_MODEL = 4
STATUS_BAD_REQUEST = 5
STATUS_CLOSED = 6
STATUS_ERROR = 7

STATUS_NAMES = {
    STATUS_OK: "ok", STATUS_BUSY: "busy",
    STATUS_OVER_QUOTA: "over_quota", STATUS_TIMEOUT: "timeout",
    STATUS_UNKNOWN_MODEL: "unknown_model",
    STATUS_BAD_REQUEST: "bad_request", STATUS_CLOSED: "closed",
    STATUS_ERROR: "error",
}
STATUS_CODES = {v: k for k, v in STATUS_NAMES.items()}

# HTTP status per outcome: both shedding outcomes are 429 (the typed
# JSON body and Retry-After distinguish quota from backpressure),
# deadline expiry is the gateway-timeout class
HTTP_STATUS = {
    "ok": 200, "busy": 429, "over_quota": 429, "timeout": 504,
    "unknown_model": 404, "bad_request": 400, "closed": 503,
    "error": 500,
}

# served operations beyond plain prediction (the reference's
# doc/retrieval.md): a
# request names ``model#op[:k]`` — ``embed`` (the served node's
# vectors; identical dispatch to predict, named for intent), ``search``
# (rows are query VECTORS, top-k over the model's sealed index) and
# ``fsearch`` (rows are model INPUTS; embed -> search composed in one
# request on ONE resolved model entry — the fan_out=1 form of
# /v1/search). The suffix rides the existing model-id field on both
# protocols, so the binary wire needs no new frame grammar.
SERVE_OPS = ("embed", "search", "fsearch")


def parse_model_op(model_id: str) -> Tuple[str, str, Optional[int]]:
    """Split ``model#op[:k]`` -> (model, op, k). Plain ids pass
    through as (id, "", None); an unknown op or malformed k raises
    ValueError (-> bad_request)."""
    base, sep, op = model_id.partition("#")
    if not sep:
        return model_id, "", None
    op, ksep, kstr = op.partition(":")
    if op not in SERVE_OPS:
        raise ValueError("unknown serve op %r (one of %s)"
                         % (op, "/".join(SERVE_OPS)))
    k = None
    if ksep:
        k = int(kstr)                    # ValueError -> bad_request
        if k < 1:
            raise ValueError("search k must be >= 1, got %d" % k)
    return base, op, k


def pack_search_result(ids: np.ndarray, scores: np.ndarray
                       ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """One wire form of a top-k answer for both protocols: the result
    rows are the (n, 2k) float32 block ``[ids | scores]`` (the binary
    reply ships it as it is; doc ids are exact in float32 up to 2**24
    corpus rows) and the extra dict carries the JSON lists the HTTP
    handler answers with."""
    payload = np.concatenate(
        [ids.astype(np.float32), scores.astype(np.float32)], axis=1)
    extra = {"k": int(ids.shape[1]), "ids": ids.tolist(),
             "scores": scores.tolist()}
    return payload, extra


def pack_request(model: str, tenant: str, rows: np.ndarray,
                 timeout_ms: float = 0.0) -> bytes:
    """Encode one binary-protocol request frame."""
    rows = np.ascontiguousarray(rows, dtype="<f4")
    if rows.ndim == 1:
        rows = rows[None, :]
    flat = rows.reshape(rows.shape[0], -1)
    m, t = model.encode(), tenant.encode()
    if len(m) > 255 or len(t) > 255:
        raise ValueError("model/tenant ids are limited to 255 bytes")
    return (_REQ_HEADER.pack(BIN_MAGIC, len(m), len(t), flat.shape[0],
                             flat.shape[1], float(timeout_ms))
            + m + t + flat.tobytes())


def pack_reply(status: int, payload: np.ndarray = None,
               message: str = "") -> bytes:
    """Encode one binary-protocol reply frame."""
    if status == STATUS_OK:
        flat = np.ascontiguousarray(payload, dtype="<f4")
        flat = flat.reshape(flat.shape[0], -1)
        return (_REP_HEADER.pack(BIN_MAGIC, status, flat.shape[0],
                                 flat.shape[1]) + flat.tobytes())
    msg = message.encode()
    return (_REP_HEADER.pack(BIN_MAGIC, status, 0, 0)
            + _MSG_LEN.pack(len(msg)) + msg)


def pack_request_v2(corr: int, model: str, tenant: str,
                    rows: np.ndarray,
                    timeout_ms: float = 0.0) -> bytes:
    """Encode one protocol-v2 request frame (correlation-tagged)."""
    rows = np.ascontiguousarray(rows, dtype="<f4")
    if rows.ndim == 1:
        rows = rows[None, :]
    flat = rows.reshape(rows.shape[0], -1)
    m, t = model.encode(), tenant.encode()
    if len(m) > 255 or len(t) > 255:
        raise ValueError("model/tenant ids are limited to 255 bytes")
    return (_REQ_HEADER_V2.pack(BIN_MAGIC_V2, corr, len(m), len(t),
                                flat.shape[0], flat.shape[1],
                                float(timeout_ms))
            + m + t + flat.tobytes())


def pack_ping_v2(corr: int = 0) -> bytes:
    """The v2 PING frame (zero rows, zero ids): answered ok without
    touching the request core — the negotiation probe."""
    return _REQ_HEADER_V2.pack(BIN_MAGIC_V2, corr, 0, 0, 0, 0, 0.0)


def pack_reply_v2(corr: int, status: int, payload: np.ndarray = None,
                  message: str = "") -> bytes:
    """Encode one protocol-v2 reply frame. ``payload is None`` with
    an ok status encodes the zero-row pong."""
    if status == STATUS_OK:
        if payload is None:
            return _REP_HEADER_V2.pack(BIN_MAGIC_V2, corr, status,
                                       0, 0)
        flat = np.ascontiguousarray(payload, dtype="<f4")
        flat = flat.reshape(flat.shape[0], -1)
        return (_REP_HEADER_V2.pack(BIN_MAGIC_V2, corr, status,
                                    flat.shape[0], flat.shape[1])
                + flat.tobytes())
    msg = message.encode()
    return (_REP_HEADER_V2.pack(BIN_MAGIC_V2, corr, status, 0, 0)
            + _MSG_LEN.pack(len(msg)) + msg)


def _read_exact(rfile, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            return None if not buf else buf  # torn frame signals below
        buf += chunk
    return buf


def _read_body(rfile, n: int) -> Optional[bytearray]:
    """Read exactly n bytes into a new buffer (writable, so the row
    view over it is a plain array); None on a torn stream."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            return None
        got += k
    return buf


def _read_reply_payload(rfile, status: int, nrows: int,
                        elems: int) -> Tuple[str, Any]:
    """Read a reply frame's payload (shared by both protocol
    versions) -> (status_name, rows | message)."""
    name = STATUS_NAMES.get(status, "error")
    if status == STATUS_OK:
        payload = _read_exact(rfile, nrows * elems * 4)
        if payload is None or len(payload) < nrows * elems * 4:
            raise IOError("connection closed mid-payload")
        return name, np.frombuffer(payload, "<f4").reshape(nrows,
                                                           elems)
    raw = _read_exact(rfile, _MSG_LEN.size)
    if raw is None or len(raw) < _MSG_LEN.size:
        raise IOError("connection closed mid-reply")
    mlen = _MSG_LEN.unpack(raw)[0]
    msg = _read_exact(rfile, mlen) if mlen else b""
    return name, (msg or b"").decode(errors="replace")


def read_reply(rfile) -> Tuple[str, Any]:
    """Read one v1 reply frame -> (status_name, rows | message)."""
    hdr = _read_exact(rfile, _REP_HEADER.size)
    if hdr is None or len(hdr) < _REP_HEADER.size:
        raise IOError("connection closed mid-reply")
    magic, status, nrows, elems = _REP_HEADER.unpack(hdr)
    if magic != BIN_MAGIC:
        raise IOError("bad reply magic %r" % magic)
    return _read_reply_payload(rfile, status, nrows, elems)


def read_reply_tagged(rfile) -> Tuple[Optional[int], str, Any]:
    """Read one reply frame of EITHER protocol version ->
    (corr_id, status_name, rows | message); a v1 frame reports
    ``corr_id = None`` — how a v2 client's negotiation probe detects
    a v1-only server."""
    magic = _read_exact(rfile, 4)
    if magic is None or len(magic) < 4:
        raise IOError("connection closed mid-reply")
    if magic == BIN_MAGIC:
        rest = _read_exact(rfile, _REP_HEADER.size - 4)
        if rest is None or len(rest) < _REP_HEADER.size - 4:
            raise IOError("connection closed mid-reply")
        _, status, nrows, elems = _REP_HEADER.unpack(magic + rest)
        name, payload = _read_reply_payload(rfile, status, nrows,
                                            elems)
        return None, name, payload
    if magic != BIN_MAGIC_V2:
        raise IOError("bad reply magic %r" % magic)
    rest = _read_exact(rfile, _REP_HEADER_V2.size - 4)
    if rest is None or len(rest) < _REP_HEADER_V2.size - 4:
        raise IOError("connection closed mid-reply")
    _, corr, status, nrows, elems = _REP_HEADER_V2.unpack(magic + rest)
    name, payload = _read_reply_payload(rfile, status, nrows, elems)
    return corr, name, payload


class BinaryClient:
    """Minimal persistent-connection client for the binary protocol
    (the closed-loop drive in tests and ``tools/serve_bench.py``)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        # request/reply framing over small segments: Nagle + delayed
        # ACK turns every exchange into a ~40ms stall
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self.sock.makefile("rb")

    def predict(self, rows: np.ndarray, model: str = "",
                tenant: str = "",
                timeout_ms: float = 0.0) -> Tuple[str, Any]:
        self.sock.sendall(pack_request(model, tenant, rows,
                                       timeout_ms))
        return read_reply(self._rfile)

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self.sock.close()


def registry_endpoints(path: str, role: str = "balancer",
                       proto: str = "binary"
                       ) -> List[Tuple[str, int]]:
    """``(host, port)`` endpoints of one role from the fleet's
    endpoint-registry file (fleet/placement.py grammar) — how a
    failover client discovers the front doors without knowing the
    controller. Draining/disabled entries are skipped."""
    with open(path) as f:
        doc = json.load(f)
    key = "%s_port" % ("binary" if proto == "binary" else "http")
    out = []
    for e in sorted(dict(doc.get("endpoints", {})).values(),
                    key=lambda e: str(e.get("id", ""))):
        if e.get("role") != role or e.get("draining"):
            continue
        port = int(e.get(key, 0))
        if port > 0:
            out.append((str(e.get("host", "127.0.0.1")), port))
    return out


class FailoverBinaryClient:
    """A :class:`BinaryClient` over MULTIPLE endpoints — the client
    half of the sharded front tier's zero-drop contract.

    Connects to one door (rotating over the list until a connect
    succeeds); any transport failure mid-exchange (refused/reset
    connection, torn frame: the signature of a door dying) — or a
    graceful ``closed`` reply from a draining door — closes the
    connection, advances to the next door, and retries the SAME rows —
    ``predict`` is idempotent, so a SIGKILLed balancer costs a
    reconnect, never a failed request. Raises IOError only when every
    endpoint refused ``attempts`` times over."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 timeout: float = 30.0, attempts: int = 0):
        if not endpoints:
            raise ValueError("failover client needs >= 1 endpoint")
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        self.timeout = timeout
        # default: two passes over the doors — one transient failure
        # per door plus the reconnect that lands on a live one
        self.attempts = attempts or 2 * len(self.endpoints)
        self._i = 0
        self.sock: Optional[socket.socket] = None
        self._rfile = None
        self.failovers = 0

    @classmethod
    def from_registry(cls, path: str,
                      timeout: float = 30.0) -> "FailoverBinaryClient":
        return cls(registry_endpoints(path, "balancer", "binary"),
                   timeout=timeout)

    def _connect(self) -> None:
        last: Optional[BaseException] = None
        for _ in range(len(self.endpoints)):
            host, port = self.endpoints[self._i % len(self.endpoints)]
            try:
                self.sock = socket.create_connection(
                    (host, port), timeout=self.timeout)
                self.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
                self._rfile = self.sock.makefile("rb")
                return
            except OSError as e:
                last = e
                self.sock = None
                self._i += 1
        raise IOError("no balancer endpoint reachable "
                      "(last: %s)" % last)

    def _drop(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass  # teardown of a dead socket on the failover path
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass  # teardown of a dead socket on the failover path
        self.sock, self._rfile = None, None
        self._i += 1           # next attempt tries the NEXT door
        self.failovers += 1

    def predict(self, rows: np.ndarray, model: str = "",
                tenant: str = "",
                timeout_ms: float = 0.0) -> Tuple[str, Any]:
        last: Optional[BaseException] = None
        for _ in range(self.attempts):
            try:
                if self.sock is None:
                    self._connect()
                self.sock.sendall(pack_request(model, tenant, rows,
                                               timeout_ms))
                status, result = read_reply(self._rfile)
                if status == "closed":
                    # a graceful goodbye: the door is draining away
                    # and did NOT process the rows — same retry
                    # contract as a dead socket
                    last = IOError("door draining: %s" % (result,))
                    self._drop()
                    continue
                return status, result
            except (OSError, ValueError) as e:
                # OSError: connect/send/recv died; ValueError: torn or
                # garbled frame — either way the exchange is void and
                # the idempotent rows retry on another door
                last = e
                self._drop()
        raise IOError("predict failed through every balancer "
                      "endpoint (last: %s)" % last)

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._rfile.close()
            finally:
                self.sock.close()
        self.sock, self._rfile = None, None


class FailoverHttpClient:
    """HTTP/JSON twin of :class:`FailoverBinaryClient`: POST
    ``/v1/predict`` against a list of doors, retrying the idempotent
    body on the next door after any transport-level failure.
    ``predict`` returns ``(http_code, decoded_json_body)``."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 timeout: float = 30.0, attempts: int = 0):
        if not endpoints:
            raise ValueError("failover client needs >= 1 endpoint")
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        self.timeout = timeout
        self.attempts = attempts or 2 * len(self.endpoints)
        self._i = 0
        self._conn: Optional[http.client.HTTPConnection] = None
        self.failovers = 0

    @classmethod
    def from_registry(cls, path: str,
                      timeout: float = 30.0) -> "FailoverHttpClient":
        return cls(registry_endpoints(path, "balancer", "http"),
                   timeout=timeout)

    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass  # teardown of a dead connection on the failover path
        self._conn = None
        self._i += 1
        self.failovers += 1

    def predict(self, model: str, tenant: str, rows,
                timeout_ms: float = 0.0) -> Tuple[int, Dict[str, Any]]:
        body = json.dumps({
            "model": model, "tenant": tenant,
            "rows": np.asarray(rows, dtype=np.float32).tolist(),
            **({"timeout_ms": timeout_ms} if timeout_ms else {})})
        last: Optional[BaseException] = None
        for _ in range(self.attempts):
            host, port = self.endpoints[self._i % len(self.endpoints)]
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        host, port, timeout=self.timeout)
                self._conn.request(
                    "POST", "/v1/predict", body,
                    {"Content-Type": "application/json"})
                resp = self._conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
                if payload.get("error") == "closed":
                    # graceful drain reply: rows were NOT processed
                    last = IOError("door draining")
                    self._drop()
                    continue
                return resp.status, payload
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                last = e
                self._drop()
        raise IOError("predict failed through every balancer "
                      "endpoint (last: %s)" % last)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self._conn = None


# -- fleet configuration --------------------------------------------------


class FleetConfig:
    """Parsed ``serve_fleet`` keys (the reference's doc/serving.md):

    - ``serve_models`` — list of ``id=source[|buckets]`` entries; the
      source is a model_dir to watch (newest verified snapshot) or an
      explicit snapshot file. Entries separate on ``,``, or on ``;``
      when any entry carries a ``|buckets`` override (bucket ladders
      are comma lists themselves: ``main=./m1;alt=./m2|1,8``).
      Default: one model ``default`` over ``model_in`` (if set) or
      ``model_dir``.
    - ``serve_http_port`` / ``serve_binary_port`` — listen ports
      (0 = ephemeral, -1 = protocol disabled).
    - ``serve_host`` — bind address (default 127.0.0.1; set 0.0.0.0
      to serve off-host).
    - ``serve_swap_poll_s`` — hot-swap watcher period (0 = no
      watchers).
    - ``serve_fleet_duration_s`` — CLI run time (0 = until
      SIGTERM/SIGINT).
    - ``serve_port_file`` — when set, ``start()`` writes a small JSON
      file (pid + resolved listen ports) there atomically; how a
      parent fleet controller learns the ephemeral ports of a replica
      it spawned (the reference's doc/serving.md "Horizontal fleet").
    - ``serve_device_mem_budget`` — MB of device memory the routed
      models' weights may hold together (0 = unlimited).
    """

    def __init__(self, cfg: Sequence):
        self.models: List[Tuple[str, str, str]] = []
        self.http_port = 0
        self.binary_port = 0
        self.host = "127.0.0.1"
        self.swap_poll_s = 2.0
        self.duration_s = 0.0
        self.mem_budget_mb = 0.0
        self.port_file = ""
        model_dir, model_in = "./models", ""
        for name, val in cfg:
            if name == "serve_models":
                self.models = self._parse_models(val)
            if name == "serve_http_port":
                self.http_port = int(val)
            if name == "serve_binary_port":
                self.binary_port = int(val)
            if name == "serve_host":
                self.host = val
            if name == "serve_swap_poll_s":
                self.swap_poll_s = float(val)
            if name == "serve_fleet_duration_s":
                self.duration_s = float(val)
            if name == "serve_device_mem_budget":
                self.mem_budget_mb = float(val)
            if name == "serve_port_file":
                self.port_file = val
            if name == "model_dir":
                model_dir = val
            if name == "model_in":
                model_in = val
        if not self.models:
            self.models = [("default", model_in or model_dir, "")]
        if self.http_port < 0 and self.binary_port < 0:
            raise ValueError(
                "serve_fleet with both protocols disabled serves "
                "nothing — enable serve_http_port or "
                "serve_binary_port")

    @staticmethod
    def _parse_models(spec: str) -> List[Tuple[str, str, str]]:
        # entries separate on ';' when any entry carries a bucket
        # override (bucket ladders are comma lists themselves:
        # ``main=./m1;alt=./m2|1,8``); a plain spec may use ','
        sep = ";" if (";" in spec or "|" in spec) else ","
        out = []
        for entry in spec.split(sep):
            entry = entry.strip()
            if not entry:
                continue
            mid, eq, src = entry.partition("=")
            if not eq or not mid or not src:
                raise ValueError(
                    "serve_models entry %r must be id=source[|buckets]"
                    % entry)
            src, _, buckets = src.partition("|")
            out.append((mid.strip(), src.strip(), buckets.strip()))
        ids = [m for m, _, _ in out]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate model id in serve_models: %r"
                             % spec)
        return out


# -- the fleet server -----------------------------------------------------


class FleetServer:
    """N routed engines + quotas + hot-swap behind two protocol
    listeners. Build from the same ordered config-pair stream as the
    rest of the system; ``start()`` binds the listeners (ephemeral
    ports resolve to ``http_port``/``binary_port`` attributes),
    ``close()`` stops watchers and listeners and drains every
    engine."""

    def __init__(self, cfg: Sequence, monitor=None, device=None):
        self.cfg = list(cfg)
        self.fleet_cfg = FleetConfig(self.cfg)
        if device is None:
            # the CLI's rule: the GPU unless ``dev`` names the CPU
            for name, val in self.cfg:
                if name == "dev":
                    device = named_device(val)
        self.device = resolve_device(device)
        self.quota = QuotaManager(self.cfg)
        # fleet-wide device-memory accounting: the router rejects a
        # register/swap whose resident weight bytes would blow the
        # budget (typed error, old model set keeps serving)
        self.router = ModelRouter(
            mem_budget_bytes=int(self.fleet_cfg.mem_budget_mb * 1e6))
        self._mon = monitor
        self._closing = False
        self._closed = False
        self._stats = threading.Lock()
        self._safe_emit = SafeEmitter(monitor,
                                      "cxxnet_tpu_torch serve frontend")
        self.counters: Dict[str, int] = {
            name: 0 for name in STATUS_NAMES.values()}
        self.counters["requests"] = 0
        self._watchers: List[SnapshotWatcher] = []
        self._http_server = None
        self._binary_server = None
        self._threads: List[threading.Thread] = []
        self.http_port = -1
        self.binary_port = -1
        try:
            for model_id, src, buckets in self.fleet_cfg.models:
                counter, path, watch_dir = self._resolve_source(src)
                session = self.build_session(path, buckets)
                try:
                    self.router.register(model_id, session, counter,
                                         path)
                except Exception:
                    session.close(drain=False)
                    raise
                if watch_dir and self.fleet_cfg.swap_poll_s > 0:
                    self._watchers.append(SnapshotWatcher(
                        self.router, model_id, watch_dir,
                        builder=lambda p, b=buckets:
                            self.build_session(p, b),
                        poll_s=self.fleet_cfg.swap_poll_s,
                        monitor=monitor))
        except BaseException:
            # a later model failing to boot (over the budget, no
            # verified snapshot) must not leave the earlier sessions'
            # dispatcher threads running
            self.router.close_all(drain=False)
            raise

    @staticmethod
    def _resolve_source(src: str) -> Tuple[int, str, str]:
        """A model source is a snapshot file or a sealed bundle
        (PINNED: served as-is, no watcher — naming an exact artifact is
        a deliberate version pin) or a model_dir (serve the newest
        verified snapshot or bundle and hot-swap as newer ones commit).
        Returns (counter, model_path, dir_to_watch) — watch dir ""
        means pinned."""
        if src.endswith(".npz") and stream_exists(src):
            return counter_of(src), src, ""
        if is_bundle(src):
            return counter_of(src), src, ""
        counter, path = latest_verified(src)
        if path is None:
            raise FileNotFoundError(
                "model source %r holds no verified snapshot" % src)
        return counter, path, src

    def build_session(self, path: str, buckets: str = "") -> \
            ServeSession:
        """Session factory shared by boot and the hot-swap shadow
        build: full warmup inside, per-model bucket override appended
        last so it wins over a global ``serve_buckets``."""
        cfg = self.cfg
        if buckets:
            cfg = cfg + [("serve_buckets", buckets)]
        return ServeSession(cfg, model_path=path, monitor=self._mon,
                            device=self.device)

    # -- the one request path both protocols share -----------------------

    def handle(self, model_id: str, tenant: str, rows,
               protocol: str = "http",
               timeout_ms: Optional[float] = None
               ) -> Tuple[str, Any, Dict[str, Any]]:
        """Route one request: quota -> router -> dispatcher. Returns
        ``(status_name, result_rows | message, extra)`` — never
        raises, so a protocol handler cannot leak a stack trace to the
        wire."""
        t0 = time.monotonic()
        nrows = 0
        resolved = model_id
        try:
            base, op, k = parse_model_op(model_id)
            resolved = base
            entry = self.router.resolve(base)
            resolved = entry.model_id
            if op in ("search", "fsearch") \
                    and entry.session.retrieval is None:
                raise ValueError("model %r serves no embedding index"
                                 % resolved)
            if op == "search":
                arr = self._shape_queries(entry, rows)
            else:
                arr = self._shape_rows(entry, rows)
            nrows = arr.shape[0]
            try:
                self.quota.admit(tenant, nrows)
            except TenantQuotaError as e:
                self._emit("tenant_shed", tenant=tenant,
                           model=resolved, rows=nrows, rate=e.rate,
                           burst=e.burst,
                           retry_after_s=round(e.retry_after_s, 3))
                raise
            if op == "search":
                out, extra = pack_search_result(
                    *self._search_current(resolved, arr, k))
            elif op == "fsearch":
                out, extra = pack_search_result(
                    *self._fanout_with_retry(resolved, arr, k,
                                             timeout_ms))
            else:
                # "" and "embed" are the same dispatch: the served
                # node's per-row vectors through the batcher
                out = self._predict_with_retry(resolved, arr,
                                               timeout_ms)
                extra = {}
            status, result = "ok", out
        except TenantQuotaError as e:
            status, result = "over_quota", str(e)
            extra = {"retry_after_s": e.retry_after_s}
        except ServeBusyError as e:
            status, result, extra = "busy", str(e), {}
        except ServeTimeoutError as e:
            status, result, extra = "timeout", str(e), {}
        except ServeClosedError as e:
            status, result, extra = "closed", str(e), {}
        except UnknownModelError as e:
            status, result, extra = "unknown_model", str(e.args[0]), {}
        except (ValueError, TypeError) as e:
            status, result, extra = "bad_request", str(e), {}
        except Exception as e:       # an engine bug must answer, not hang
            status, result, extra = "error", str(e), {}
        self._record(protocol, status, resolved, tenant, nrows, t0)
        return status, result, extra

    def _shape_rows(self, entry, rows) -> np.ndarray:
        """Coerce client rows (flat or natural layout) to the served
        instance shape; mismatches bounce as bad_request."""
        # client rows arrive as host bytes or JSON; the binary path's <f4
        # frombuffer view passes through without a copy
        arr = np.asarray(rows, dtype=np.float32)
        inst = entry.session.engine._inst_shape()
        elems = int(np.prod(inst))
        if arr.ndim == 1 and arr.size == elems:
            arr = arr.reshape((1,) + inst)
        elif arr.ndim == 2 and arr.shape[1] == elems \
                and arr.shape[1:] != inst:
            arr = arr.reshape((arr.shape[0],) + inst)
        if arr.ndim != len(inst) + 1 or arr.shape[1:] != inst:
            raise ValueError(
                "rows of shape %r do not match the served instance "
                "shape %r (%d values per row)"
                % (tuple(arr.shape), inst, elems))
        return arr

    def _shape_queries(self, entry, rows) -> np.ndarray:
        """``#search`` rows are query vectors in the index's embedding
        space (not model inputs): coerced to (n, dim) against the
        served index; mismatches bounce as bad_request."""
        arr = np.asarray(rows, dtype=np.float32)
        dim = entry.session.retrieval.index.dim
        if arr.ndim == 1 and arr.size == dim:
            arr = arr.reshape(1, dim)
        if arr.ndim != 2 or arr.shape[1] != dim:
            raise ValueError(
                "queries of shape %r do not match the index embedding "
                "dim %d" % (tuple(arr.shape), dim))
        return arr

    def handle_async(self, model_id: str, tenant: str, rows,
                     protocol: str = "binary",
                     timeout_ms: Optional[float] = None,
                     done=None) -> None:
        """Non-blocking twin of :meth:`handle` — the out-of-order
        reply path of the v2 binary protocol. Admission (routing,
        shape, quota) runs inline on the caller's thread; the dispatch
        rides the batcher's Future.
        ``done(status, result, extra)`` fires exactly once — inline
        for admission failures, from a serve worker thread otherwise
        — and, like ``handle``, this never raises."""
        if "#" in model_id:
            # ``model#op[:k]`` answers through the synchronous core:
            # search dispatches outside the batcher, and fsearch holds
            # one resolved entry across both legs, so neither rides a
            # batcher Future (handle() records the request itself, so
            # ``done`` fires directly; these replies come in
            # handler-thread completion order)
            status, result, extra = self.handle(
                model_id, tenant, rows, protocol=protocol,
                timeout_ms=timeout_ms)
            done(status, result, extra)
            return
        t0 = time.monotonic()
        state = {"nrows": 0, "model": model_id}

        def finish(status, result, extra):
            self._record(protocol, status, state["model"], tenant,
                         state["nrows"], t0)
            done(status, result, extra)

        try:
            entry = self.router.resolve(model_id)
            state["model"] = entry.model_id
            arr = self._shape_rows(entry, rows)
            state["nrows"] = arr.shape[0]
            try:
                self.quota.admit(tenant, state["nrows"])
            except TenantQuotaError as e:
                self._emit("tenant_shed", tenant=tenant,
                           model=state["model"], rows=state["nrows"],
                           rate=e.rate, burst=e.burst,
                           retry_after_s=round(e.retry_after_s, 3))
                raise
        except TenantQuotaError as e:
            finish("over_quota", str(e),
                   {"retry_after_s": e.retry_after_s})
            return
        except UnknownModelError as e:
            finish("unknown_model", str(e.args[0]), {})
            return
        except (ValueError, TypeError) as e:
            finish("bad_request", str(e), {})
            return
        except Exception as e:   # an admission bug must answer, not hang
            finish("error", str(e), {})
            return
        # a super-batch wider than one dispatch (the balancer's
        # coalesced forwards) splits into max_batch chunks and
        # reassembles — the dispatcher re-coalesces chunks onto the
        # bucket ladder, so an oversized request costs ceil(n/mb)
        # submits, not a bad_request bounce
        mb = entry.session.engine.max_batch
        if state["nrows"] > mb:
            self._dispatch_chunked(state["model"], arr, mb,
                                   timeout_ms, finish)
        else:
            self._dispatch_async(state["model"], arr, timeout_ms,
                                 finish, attempts=8)

    def _dispatch_chunked(self, model_id: str, arr: np.ndarray,
                          max_batch: int,
                          timeout_ms: Optional[float],
                          finish) -> None:
        """Fan an oversized row array out as max_batch-sized chunks
        and call ``finish`` once with the reassembled rows (or the
        first non-ok status)."""
        chunks = [arr[i:i + max_batch]
                  for i in range(0, arr.shape[0], max_batch)]
        results: List[Any] = [None] * len(chunks)
        state = {"pending": len(chunks), "failed": None}
        lock = threading.Lock()

        def chunk_finish(idx):
            def _finish(status, result, extra):
                with lock:
                    if status == "ok":
                        results[idx] = result
                    elif state["failed"] is None:
                        state["failed"] = (status, result, extra)
                    state["pending"] -= 1
                    last = state["pending"] == 0
                if not last:
                    return
                if state["failed"] is not None:
                    finish(*state["failed"])
                else:
                    finish("ok", np.concatenate(
                        [np.asarray(r) for r in results]), {})
            return _finish

        for i, chunk in enumerate(chunks):
            self._dispatch_async(model_id, chunk, timeout_ms,
                                 chunk_finish(i), attempts=8)

    def _dispatch_async(self, model_id: str, arr: np.ndarray,
                        timeout_ms: Optional[float], finish,
                        attempts: int) -> None:
        """Submit through the CURRENT session and chain ``finish``
        onto the batcher Future; the hot-swap ``ServeClosedError``
        race retries through a fresh resolve exactly like
        ``_predict_with_retry`` (the 1 ms settle runs on the retiring
        session's worker, off the request path)."""
        try:
            entry = self.router.resolve(model_id)
            fut = entry.session.submit(arr, timeout_ms)
        except ServeClosedError as e:
            if not self._closing and attempts > 1:
                time.sleep(0.001)   # let the flip commit, then re-resolve
                self._dispatch_async(model_id, arr, timeout_ms,
                                     finish, attempts - 1)
            else:
                finish("closed", str(e), {})
            return
        except ServeBusyError as e:
            finish("busy", str(e), {})
            return
        except ServeTimeoutError as e:
            finish("timeout", str(e), {})
            return
        except (ValueError, TypeError) as e:
            finish("bad_request", str(e), {})
            return
        except Exception as e:
            finish("error", str(e), {})
            return

        def _done(f):
            exc = f.exception()
            if exc is None:
                finish("ok", f.result(), {})
            elif isinstance(exc, ServeClosedError) \
                    and not self._closing and attempts > 1:
                time.sleep(0.001)
                self._dispatch_async(model_id, arr, timeout_ms,
                                     finish, attempts - 1)
            elif isinstance(exc, ServeBusyError):
                finish("busy", str(exc), {})
            elif isinstance(exc, ServeTimeoutError):
                finish("timeout", str(exc), {})
            elif isinstance(exc, ServeClosedError):
                finish("closed", str(exc), {})
            else:
                finish("error", str(exc), {})

        fut.add_done_callback(_done)

    def _predict_with_retry(self, model_id: str, arr: np.ndarray,
                            timeout_ms: Optional[float]) -> np.ndarray:
        """Dispatch through the CURRENT session for ``model_id``; a
        ``ServeClosedError`` during a hot-swap window (the request
        resolved the old session right as it began draining) retries
        through a fresh resolve — the new engine is already routed, so
        in-flight requests never fail during a swap."""
        for _ in range(8):
            entry = self.router.resolve(model_id)
            try:
                return entry.session.predict(arr, timeout_ms)
            except ServeClosedError:
                if self._closing:
                    raise
                time.sleep(0.001)   # let the flip commit, then re-resolve
        raise ServeClosedError(
            "model %r kept draining across retries" % model_id)

    def _search_current(self, model_id: str, arr: np.ndarray,
                        k: Optional[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the current entry's index. The router swaps model
        and index as one entry, so one resolve is the whole consistency
        story; the retrieval engine dispatches outside the batcher and
        never raises ServeClosedError."""
        entry = self.router.resolve(model_id)
        r = entry.session.retrieval
        if r is None:        # raced a swap to an index-less bundle
            raise ValueError("model %r serves no embedding index"
                             % model_id)
        return r.search(arr, k=k)

    def _fanout_with_retry(self, model_id: str, arr: np.ndarray,
                           k: Optional[int],
                           timeout_ms: Optional[float]
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """``fan_out = 1``: embed then search in one request on one
        resolved entry, so a hot-swap mid-flight never pairs the new
        model with the old index (or the reverse). The embed leg rides
        the batcher with plain predict traffic; a ServeClosedError
        retries the whole composition through a fresh resolve, as
        :meth:`_predict_with_retry` does."""
        for _ in range(8):
            entry = self.router.resolve(model_id)
            r = entry.session.retrieval
            if r is None:
                raise ValueError("model %r serves no embedding index"
                                 % model_id)
            try:
                vecs = entry.session.predict(arr, timeout_ms)
            except ServeClosedError:
                if self._closing:
                    raise
                time.sleep(0.001)
                continue
            vecs = np.asarray(vecs, dtype=np.float32)
            return r.search(vecs.reshape(vecs.shape[0], -1), k=k)
        raise ServeClosedError(
            "model %r kept draining across retries" % model_id)

    # -- telemetry / accounting -------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        # telemetry failure must not fail requests; SafeEmitter owns
        # the warn-once latch (shared with DynamicBatcher)
        self._safe_emit(kind, **fields)

    def _record(self, protocol: str, status: str, model: str,
                tenant: str, rows: int, t0: float) -> None:
        with self._stats:
            self.counters["requests"] += 1
            self.counters[status] = self.counters.get(status, 0) + 1
        self._emit("serve_http", protocol=protocol, status=status,
                   model=model, tenant=tenant, rows=rows,
                   latency_ms=(time.monotonic() - t0) * 1e3)

    # runtime-fingerprint hashes are constant per (process, device):
    # memoize so the introspection endpoints operators poll do not
    # re-query the driver per model per request
    _fp_sha_cache: Dict[str, str] = {}

    @classmethod
    def _fingerprint_sha(cls, device: torch.device) -> str:
        key = str(device)
        sha = cls._fp_sha_cache.get(key)
        if sha is None:
            sha = fingerprint_sha(runtime_fingerprint(device))
            cls._fp_sha_cache[key] = sha
        return sha

    def describe(self) -> List[Dict[str, Any]]:
        """Model table with the client-facing dispatch contract."""
        out = []
        for e in (self.router.resolve(m) for m in self.router.ids()):
            inst = e.session.engine._inst_shape()
            out.append({
                "model": e.model_id, "counter": e.counter,
                "path": e.path, "generation": e.generation,
                "max_batch": e.session.engine.max_batch,
                "row_elems": int(np.prod(inst)),
                "instance_shape": list(inst),
                "buckets": list(e.session.engine.buckets),
                # per-model device-memory accounting
                "device_mem_bytes": e.resident_bytes,
                # version identity: the counter this engine was booted
                # from, whether the source was a sealed bundle, and the
                # hash of the runtime its kernels and weights were
                # built for
                "bundle": bool(is_bundle(e.path)),
                "fingerprint_sha256": self._fingerprint_sha(
                    e.session.engine.device),
            })
            r = e.session.retrieval
            if r is not None:
                # the search contract clients compose against: what
                # /v1/search accepts and the k it answers by default
                out[-1]["index"] = r.describe()
        return out

    def health_snapshot(self) -> Dict[str, Any]:
        """Load-aware health for ``GET /healthz`` — the signals a fleet
        balancer routes on and an autoscaler differentiates between
        polls: cumulative
        request/shed/error counters, current queued rows, lifetime
        p99, resident device bytes, and per-model version identity +
        compile accounting."""
        with self._stats:
            c = dict(self.counters)
        shed = c.get("busy", 0) + c.get("over_quota", 0)
        models = []
        queue_rows = 0
        p99 = 0.0
        for e in (self.router.resolve(m) for m in self.router.ids()):
            batcher = e.session.batcher
            # read each signal ONCE so the per-model rows always sum/
            # max to the aggregates (and each poll takes the batcher
            # locks once per model, not twice)
            m_queue = batcher.queue_rows()
            m_p99 = batcher.latency_percentile(0.99)
            queue_rows += m_queue
            p99 = max(p99, m_p99)
            snap = e.session.engine.counters_snapshot()
            row = {
                "model": e.model_id, "counter": e.counter,
                "generation": e.generation,
                "max_batch": e.session.engine.max_batch,
                "queue_rows": m_queue,
                "p99_ms": round(m_p99, 3),
                "compile_events": snap["compile_events"],
                "aot_hits": snap["aot_hits"],
            }
            r = e.session.retrieval
            if r is not None:
                # search keeps its own books: the zero-compile boot
                # covers predict and search dispatch
                rsnap = r.counters_snapshot()
                row["search_compile_events"] = rsnap["compile_events"]
                row["search_aot_hits"] = rsnap["aot_hits"]
            # cumulative batch economics (fill/pad): what a fleet bench
            # aggregates across replicas
            row.update(batcher.fill_stats())
            models.append(row)
        return {
            "ok": True, "pid": os.getpid(),
            "models": self.router.ids(),
            "requests": c["requests"], "shed": shed,
            "errors": c.get("error", 0) + c.get("closed", 0),
            "queue_rows": queue_rows,
            "p99_ms": round(p99, 3),
            "resident_bytes": self.router.resident_bytes_total(),
            "model_health": models,
        }

    # -- listeners --------------------------------------------------------

    def start(self) -> None:
        c = self.fleet_cfg
        if c.http_port >= 0:
            self._http_server = _FleetHTTPServer(
                (c.host, c.http_port), _HttpHandler, self)
            self.http_port = self._http_server.server_address[1]
            t = threading.Thread(
                target=self._http_server.serve_forever,
                name="serve-http", daemon=True)
            t.start()
            self._threads.append(t)
        if c.binary_port >= 0:
            self._binary_server = _FleetBinaryServer(
                (c.host, c.binary_port), _BinaryHandler, self)
            self.binary_port = \
                self._binary_server.server_address[1]
            t = threading.Thread(
                target=self._binary_server.serve_forever,
                name="serve-binary", daemon=True)
            t.start()
            self._threads.append(t)
        for w in self._watchers:
            w.start()
        if c.port_file:
            self._write_port_file(c.port_file)

    def notify_watchers(self) -> None:
        """Kick every hot-swap watcher for an immediate poll — the
        in-process exporter's post-commit hook (the continual loop
        calls this right after committing a generation so the flip
        does not wait out ``serve_swap_poll_s``)."""
        for w in self._watchers:
            w.notify()

    def _write_port_file(self, path: str) -> None:
        """Atomically publish the resolved listen ports (tmp +
        rename): a fleet controller polling for this file must never
        read a torn write."""
        payload = json.dumps({"pid": os.getpid(),
                              "http_port": self.http_port,
                              "binary_port": self.binary_port})
        d = os.path.dirname(os.path.abspath(path))
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)

    def close(self, drain: bool = True) -> Dict[str, Any]:
        """Stop watchers, stop intake (listeners), drain every
        engine. Idempotent; returns the fleet summary."""
        if self._closed:
            return self._summary({})
        self._closed = True
        self._closing = True
        for w in self._watchers:
            w.close()
        for srv in (self._http_server, self._binary_server):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        for t in self._threads:
            t.join(timeout=30)
        summaries = self.router.close_all(drain=drain)
        return self._summary(summaries)

    def _summary(self, per_model: Dict[str, Dict]) -> Dict[str, Any]:
        with self._stats:
            c = dict(self.counters)
        return {"requests": c, "models": per_model,
                "quota": self.quota.snapshot(),
                "swaps": sum(w.swaps for w in self._watchers)}


# -- HTTP protocol --------------------------------------------------------


class _FleetHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, handler, fleet: FleetServer):
        self.fleet = fleet
        super().__init__(addr, handler)


class _HttpHandler(BaseHTTPRequestHandler):
    server_version = "cxxnet-serve"
    protocol_version = "HTTP/1.1"

    def _send_json(self, code: int, obj: Dict[str, Any],
                   headers: Dict[str, str] = ()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        fleet = self.server.fleet
        if self.path == "/healthz":
            self._send_json(200, fleet.health_snapshot())
        elif self.path == "/v1/models":
            self._send_json(200, {"models": fleet.describe()})
        else:
            self._send_json(404, {"error": "not_found",
                                  "message": "unknown path %r"
                                  % self.path})

    def do_POST(self):
        fleet = self.server.fleet
        if self.path not in ("/v1/predict", "/v1/embed",
                             "/v1/search"):
            self._send_json(404, {"error": "not_found",
                                  "message": "POST /v1/predict, "
                                  "/v1/embed or /v1/search"})
            return
        t0 = time.monotonic()
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            model = str(req.get("model", ""))
            tenant = str(req.get("tenant", ""))
            timeout_ms = req.get("timeout_ms")
            rows = req["rows"]
            # the endpoints are sugar over the op-suffix grammar the
            # shared core (and the binary protocol) speak natively
            op_model = model
            if self.path == "/v1/embed":
                op_model = model + "#embed"
            elif self.path == "/v1/search":
                op = "fsearch" if int(req.get("fan_out", 0) or 0) \
                    else "search"
                k = req.get("k")
                op_model = model + "#" + op + \
                    (":%d" % int(k) if k is not None else "")
        except (ValueError, KeyError, TypeError) as e:
            # malformed body: never reached the shared core, so the
            # request is recorded here for the stream's completeness
            fleet._record("http", "bad_request", "", "", 0, t0)
            self._send_json(400, {"error": "bad_request",
                                  "message": "body must be JSON with "
                                  "'rows': %s" % e})
            return
        status, result, extra = fleet.handle(
            op_model, tenant, rows, protocol="http",
            timeout_ms=timeout_ms)
        code = HTTP_STATUS[status]
        if status == "ok" and "ids" in extra:
            self._send_json(code, {
                "model": model or fleet.router.default_id,
                "rows": len(extra["ids"]), "k": extra["k"],
                "ids": extra["ids"], "scores": extra["scores"]})
            return
        if status == "ok":
            flat = np.asarray(result)
            self._send_json(code, {
                "model": model or fleet.router.default_id,
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

    def log_message(self, fmt, *args):   # stdout parity: no access log
        pass


# -- binary protocol ------------------------------------------------------


class _FleetBinaryServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def process_request(self, request, client_address):
        # the reply side writes header and payload as separate small
        # segments; without TCP_NODELAY, Nagle holds the second one
        # for the peer's delayed ACK (~40ms per exchange)
        request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        super().process_request(request, client_address)

    def __init__(self, addr, handler, fleet: FleetServer):
        self.fleet = fleet
        super().__init__(addr, handler)


class _V2ConnState:
    """Out-of-order reply half of one v2 binary connection:
    completion callbacks frame (corr, status, result) straight onto
    the socket in COMPLETION order, serialized by a write lock — a
    slow request never blocks the replies behind it (no head-of-line
    blocking), and a completed reply reaches the wire with no thread
    hop (a dedicated reply thread measured as a p99 convoy under GIL
    pressure: every reply of the connection serialized behind one
    thread's scheduling). The write into the kernel socket buffer is
    microseconds for these frames; ``finish()`` holds teardown until
    the in-flight requests have answered."""

    def __init__(self, wfile, wlock):
        self._wfile = wfile
        # the CONNECTION's write lock, shared with the handler's v1
        # reply writes: per-frame negotiation allows v1 and v2 frames
        # interleaved on one connection, and a v1 reply on the handler
        # thread must not interleave bytes with a concurrent v2
        # completion write
        self._wlock = wlock
        self._lock = threading.Lock()
        self._pending = 0
        self._drained = threading.Condition(self._lock)

    def begin(self) -> None:
        with self._lock:
            self._pending += 1

    def reply(self, corr: int, status: str, result) -> None:
        """Immediate reply (pings, inline admission failures answered
        through complete() instead — this one does not pair with a
        begin())."""
        self._write(corr, status, result)

    def complete(self, corr: int, status: str, result) -> None:
        self._write(corr, status, result)
        with self._lock:
            self._pending -= 1
            if self._pending == 0:
                self._drained.notify_all()

    def finish(self) -> None:
        """Read loop done (EOF/torn frame): wait for the in-flight
        requests to answer before the connection tears down."""
        with self._lock:
            deadline = time.monotonic() + 60
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)

    def _write(self, corr: int, status: str, result) -> None:
        try:
            if status == "ok":
                frame = pack_reply_v2(corr, STATUS_OK, payload=result)
            else:
                frame = pack_reply_v2(corr, STATUS_CODES[status],
                                      message=str(result))
            with self._wlock:
                self._wfile.write(frame)
        except (OSError, ValueError):
            # client went away mid-stream: there is no one to answer,
            # but the in-flight accounting must still drain
            pass  # no recipient; complete() keeps shutdown bounded


class _BinaryHandler(socketserver.StreamRequestHandler):
    """Persistent connection, both protocol versions per frame: an
    untagged v1 frame gets the classic one-in-one-out round trip; a
    correlation-tagged v2 frame is dispatched asynchronously and its
    reply may overtake slower neighbors (out-of-order, pipelined). A
    malformed frame answers bad_request and drops the connection (a
    desynced length-prefixed stream cannot be re-synchronized)."""

    def handle(self):
        fleet = self.server.fleet
        self._v2 = None
        # one write lock per connection: v1 replies (handler thread)
        # and v2 completion writes (worker threads) share the socket
        self._wlock = threading.Lock()
        try:
            while True:
                magic = _read_exact(self.rfile, 4)
                if magic is None or len(magic) < 4:
                    return                    # EOF (torn magic: drop)
                if magic == BIN_MAGIC:
                    if not self._handle_v1(fleet, magic):
                        return
                elif magic == BIN_MAGIC_V2:
                    if not self._handle_v2(fleet, magic):
                        return
                else:
                    self._write_v1(pack_reply(
                        STATUS_BAD_REQUEST,
                        message="bad frame magic %r" % magic))
                    return
        finally:
            if self._v2 is not None:
                self._v2.finish()

    def _write_v1(self, frame: bytes) -> None:
        with self._wlock:
            self.wfile.write(frame)

    def _read_frame(self, magic: bytes):
        """Read one request frame after its magic; returns
        (corr, model, tenant, rows, timeout_ms) or an error string,
        or None on a torn stream (drop silently)."""
        v2 = magic == BIN_MAGIC_V2
        header = _REQ_HEADER_V2 if v2 else _REQ_HEADER
        rest = _read_exact(self.rfile, header.size - 4)
        if rest is None or len(rest) < header.size - 4:
            return None
        if v2:
            _, corr, mlen, tlen, nrows, elems, timeout_ms = \
                header.unpack(magic + rest)
        else:
            corr = None
            _, mlen, tlen, nrows, elems, timeout_ms = \
                header.unpack(magic + rest)
        if nrows > MAX_FRAME_ROWS \
                or nrows * max(1, elems) * 4 > MAX_FRAME_BYTES:
            return "bad frame header (%d x %d)" % (nrows, elems)
        if v2 and nrows == 0 and elems == 0 and mlen == 0 \
                and tlen == 0:
            return ("ping", corr)
        body = _read_body(self.rfile, mlen + tlen + nrows * elems * 4)
        if body is None:
            return None
        model = body[:mlen].decode(errors="replace")
        tenant = body[mlen:mlen + tlen].decode(errors="replace")
        # zero-copy ingress: the frame's row bytes become a float32 VIEW
        # of the buffer they were read into (frombuffer at an offset: a
        # slice would copy the whole payload), which the engine's
        # staging copies from exactly once
        rows = np.frombuffer(body, "<f4",
                             offset=mlen + tlen).reshape(nrows,
                                                         elems) \
            if nrows else np.zeros((0, max(1, elems)), np.float32)
        return corr, model, tenant, rows, timeout_ms

    def _handle_v1(self, fleet, magic: bytes) -> bool:
        frame = self._read_frame(magic)
        if frame is None:
            return False
        if isinstance(frame, str):   # pings are v2-only
            self._write_v1(pack_reply(STATUS_BAD_REQUEST,
                                      message=frame))
            return False
        _, model, tenant, rows, timeout_ms = frame
        status, result, _ = fleet.handle(
            model, tenant, rows, protocol="binary",
            timeout_ms=timeout_ms if timeout_ms > 0 else None)
        if status == "ok":
            self._write_v1(pack_reply(STATUS_OK, payload=result))
        else:
            self._write_v1(pack_reply(STATUS_CODES[status],
                                      message=str(result)))
        return True

    def _handle_v2(self, fleet, magic: bytes) -> bool:
        frame = self._read_frame(magic)
        if frame is None:
            return False
        if self._v2 is None:
            self._v2 = _V2ConnState(self.wfile, self._wlock)
        if isinstance(frame, str):
            self._v2.reply(0, "bad_request", frame)
            return False
        if frame[0] == "ping":
            # pong without touching the core (the negotiation probe,
            # and the deterministic out-of-order witness in tests)
            self._v2.reply(frame[1], "ok", None)
            return True
        corr, model, tenant, rows, timeout_ms = frame
        st = self._v2
        st.begin()
        if hasattr(fleet, "handle_async"):
            fleet.handle_async(
                model, tenant, rows, protocol="binary",
                timeout_ms=timeout_ms if timeout_ms > 0 else None,
                done=lambda s, r, e, c=corr: st.complete(c, s, r))
        else:
            # a core without an async surface (the balancer) answers
            # v2 frames in order — correlation ids still correct
            status, result, _ = fleet.handle(
                model, tenant, rows, protocol="binary",
                timeout_ms=timeout_ms if timeout_ms > 0 else None)
            st.complete(corr, status, result)
        return True
