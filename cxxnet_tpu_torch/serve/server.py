"""Config-driven serve session: snapshot -> engine -> batcher
(counterpart of ``cxxnet_tpu/serve/server.py``).

``ServeSession`` is the library surface: it loads a snapshot (or a
sealed bundle, ``artifact/bundle.py``) into a frozen :class:`~cxxnet_tpu_torch.serve.engine.InferenceEngine`, warms
its bucket ladder, fronts it with a
:class:`~cxxnet_tpu_torch.serve.batcher.DynamicBatcher`, and exposes
``submit`` / ``predict`` / ``close``. Knobs come from the same ``key =
value`` grammar as the reference:

- ``serve_buckets`` — ``auto`` or an explicit comma list like ``1,8,32``
- ``serve_max_batch`` — micro-batch row cap (default: ``batch_size``)
- ``serve_max_delay_ms`` — batch-close deadline (default 2 ms)
- ``serve_queue_rows`` — backpressure bound (default 8x max_batch)
- ``serve_timeout_ms`` — default per-request deadline (0 = none)
- ``serve_node`` — node to serve (default: the top node)
- ``serve_warm_run`` — run each bucket once at warmup (default 1)
- ``serve_dtype`` — ``float32`` (default), ``bfloat16`` (bf16 staging,
  convolutions and activations) or ``int8`` (a snapshot with
  calibration tables; int8 products into int32, dequantized in the
  conv_epilogue kernel)
- ``serve_device_mem_budget`` — MB of device memory the model's
  masters and frozen serve weights may hold (0 = unlimited): the
  warmup's freeze rejects a larger model with
  :class:`~cxxnet_tpu_torch.artifact.registry.ResidencyBudgetError`
  before the tree is made, and the session is not built
- ``serve_clients`` / ``serve_requests`` / ``serve_request_rows`` —
  the CLI soak drive (``task = serve``): N closed-loop clients each
  issuing M requests of K rows
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.config import NotPortedError, Roadmap
from .batcher import DynamicBatcher, ServeBusyError, ServeTimeoutError
from .engine import InferenceEngine, build_engine


def _refuse_sealed_index(model_path: str) -> None:
    """A bundle that seals an embedding index is served with its search
    operations by the reference; retrieval is not ported, so its model
    part is not served without them either."""
    from ..artifact import bundle as _ab
    if _ab.is_bundle(model_path) \
            and _ab.bundle_manifest(model_path).get("index") is not None:
        raise NotPortedError(
            "the embedding index sealed in bundle %r" % model_path,
            Roadmap.RETRIEVAL)


class ServeConfig:
    """Parsed ``serve_*`` keys (plus the globals serving depends on)."""

    def __init__(self, cfg: Sequence) -> None:
        self.buckets = "auto"
        self.max_batch = 0
        self.max_delay_ms = 2.0
        self.queue_rows = 0
        self.timeout_ms = 0.0
        self.node = ""
        self.warm_run = 1
        self.clients = 8
        self.requests = 32
        self.request_rows = 1
        batch_size = 0
        for name, val in cfg:
            if name == "batch_size":
                batch_size = int(val)
            if name == "serve_buckets":
                self.buckets = val
            if name == "serve_max_batch":
                self.max_batch = int(val)
            if name == "serve_max_delay_ms":
                self.max_delay_ms = float(val)
            if name == "serve_queue_rows":
                self.queue_rows = int(val)
            if name == "serve_timeout_ms":
                self.timeout_ms = float(val)
            if name == "serve_node":
                self.node = val
            if name == "serve_warm_run":
                self.warm_run = int(val)
            if name == "serve_clients":
                self.clients = int(val)
            if name == "serve_requests":
                self.requests = int(val)
            if name == "serve_request_rows":
                self.request_rows = int(val)
        if not self.max_batch:
            self.max_batch = batch_size
        if not self.max_batch:
            raise ValueError(
                "serving needs serve_max_batch (or batch_size)")


class ServeSession:
    """A long-lived concurrent predictor over one snapshot.

    Build from config + model path (the engine runs on ``device``, the
    GPU by default) or around an existing engine. ``close`` drains
    in-flight work and returns the summary.
    """

    def __init__(self, cfg: Sequence = (),
                 model_path: Optional[str] = None,
                 engine: Optional[InferenceEngine] = None,
                 monitor=None, device=None):
        self.cfg = ServeConfig(cfg)
        c = self.cfg
        if engine is None:
            if not model_path:
                raise ValueError("ServeSession needs model_path or engine")
            _refuse_sealed_index(model_path)
            engine = build_engine(cfg, model_path, buckets=c.buckets,
                                  max_batch=c.max_batch, node=c.node,
                                  device=device, monitor=monitor)
        self.engine = engine
        # retrieval is not ported: no session holds an embedding index,
        # and the fleet answers search requests as the reference does
        # for an index-less model
        self.retrieval = None
        self.index_bytes = 0
        self.batcher = DynamicBatcher(
            engine.stage, engine.dispatch,
            max_batch=engine.max_batch, max_delay_ms=c.max_delay_ms,
            max_queue_rows=c.queue_rows, timeout_ms=c.timeout_ms,
            monitor=monitor, row_shape=engine._inst_shape(),
            extra_summary=self._engine_summary)
        self._closed = False
        # the warmup runs on the batcher's dispatch thread, where the
        # forwards will run: PyTorch's cuDNN handles and execution-plan
        # cache are per thread, so a bucket warmed on another thread
        # pays its first-use cost again on a client's request
        try:
            self.warmup_programs = self.batcher.run_in_dispatcher(
                lambda: engine.warmup(warm_run=bool(c.warm_run)))
        except BaseException:
            self.batcher.close(drain=False)
            raise

    def _engine_summary(self) -> Dict[str, int]:
        snap = self.engine.counters_snapshot()
        res = self.engine.trainer.residency
        return {"compile_events": snap["compile_events"],
                "aot_hits": snap["aot_hits"],
                "d2h_bytes": snap["d2h_bytes"],
                "staging_reuse": snap["staging_reuse"],
                "staging_alloc": snap["staging_alloc"],
                "resident_bytes": res["bytes"] if res else 0}

    def submit(self, rows: np.ndarray,
               timeout_ms: Optional[float] = None):
        """Queue rows (NHWC layout); returns their result Future."""
        return self.batcher.submit(rows, timeout_ms)

    def predict(self, rows: np.ndarray,
                timeout_ms: Optional[float] = None) -> np.ndarray:
        """Blocking score: the served node's rows for ``rows``."""
        return self.batcher(rows, timeout_ms)

    def close(self, drain: bool = True) -> Dict[str, Any]:
        if self._closed:
            return self.batcher.summary()
        self._closed = True
        return self.batcher.close(drain=drain)


def run_closed_loop(session: ServeSession, pool: np.ndarray,
                    clients: int, requests: int,
                    request_rows: int = 1) -> Dict[str, Any]:
    """Drive ``clients`` threaded closed-loop clients through the
    session: each sends ``requests`` requests of ``request_rows``
    consecutive pool rows (wrapping), waiting for each result before
    sending the next. Returns aggregate stats; a failed request counts
    in ``error`` and does not stop its client."""
    results: List[Dict[str, int]] = [
        {"ok": 0, "busy": 0, "timeout": 0, "error": 0}
        for _ in range(clients)]
    npool = pool.shape[0]

    def client(ci: int) -> None:
        for r in range(requests):
            start = ((ci * requests + r) * request_rows) % npool
            rows = np.take(pool, range(start, start + request_rows),
                           axis=0, mode="wrap")
            try:
                session.predict(rows)
                results[ci]["ok"] += 1
            except ServeBusyError:
                results[ci]["busy"] += 1
            except ServeTimeoutError:
                results[ci]["timeout"] += 1
            except Exception:
                results[ci]["error"] += 1

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,),
                                name="serve-client-%d" % i)
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    agg = {k: sum(r[k] for r in results)
           for k in ("ok", "busy", "timeout", "error")}
    agg["wall_s"] = wall
    agg["clients"] = clients
    agg["rows"] = agg["ok"] * request_rows
    agg["rows_per_sec"] = agg["rows"] / wall if wall > 0 else 0.0
    return agg
