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
  convolutions and activations), ``int8`` (a snapshot with
  calibration tables; int8 products into int32, dequantized in the
  conv_epilogue kernel) or ``fp8`` (the same tables; e4m3 products
  into float32, dequantized alike)
- ``serve_device_mem_budget`` — MB of device memory the model's
  masters and frozen serve weights may hold (0 = unlimited): the
  warmup's freeze rejects a larger model with
  :class:`~cxxnet_tpu_torch.artifact.registry.ResidencyBudgetError`
  before the tree is made, and the session is not built
- ``serve_clients`` / ``serve_requests`` / ``serve_request_rows`` —
  the CLI soak drive (``task = serve``): N closed-loop clients each
  issuing M requests of K rows
- ``search_k`` / ``search_buckets`` — a bundle that seals an embedding
  index gets a :class:`~cxxnet_tpu_torch.retrieval.engine.
  RetrievalEngine` beside the predictor (``session.retrieval``), on the
  same device and under the same budget (weights + index); these keys
  override the search depth and query ladder the bundle sealed (0 /
  "" defer to it)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .batcher import DynamicBatcher, ServeBusyError, ServeTimeoutError
from .engine import InferenceEngine, build_engine


def parse_search_buckets(spec: str, sealed=None):
    """The query ladder: an explicit ``search_buckets`` list wins, unset
    falls back to the ladder a bundle ``sealed``, and ``auto`` (or
    neither) gives None (the engine's default ladder)."""
    if spec and spec != "auto":
        return tuple(sorted({int(t) for t in spec.split(",")
                             if t.strip()}))
    if spec != "auto" and sealed:
        return tuple(int(b) for b in sealed)
    return None


def warm_retrieval(index, engine: InferenceEngine, k: int, buckets,
                   warm_run: bool):
    """A :class:`~cxxnet_tpu_torch.retrieval.engine.RetrievalEngine` over
    ``index`` on ``engine``'s device, warmed under the budget its weights
    froze under (the index bytes stack on the frozen tree's)."""
    from ..retrieval import RetrievalEngine
    t = engine.trainer
    r = RetrievalEngine(index, engine.device, k=k, buckets=buckets)
    res = t.residency
    r.warmup(warm_run=warm_run,
             budget_bytes=int(t.serve_device_mem_budget * 1e6),
             weight_bytes=res["bytes"] if res else 0)
    return r


def build_retrieval(engine: InferenceEngine, rows: np.ndarray, sc,
                    monitor=None, out: str = "", t0: Optional[float] = None):
    """Embed raw host ``rows`` through ``engine``'s bucketed dispatch (the
    one ``/v1/embed`` serves), build the exact index over them (ids 0..n-1,
    ``sc.index_metric``, ``sc.node``) and warm a retrieval engine on it
    (:func:`warm_retrieval` at ``sc.search_k`` and ``sc.search_buckets``).
    Emits the ``index_build`` record for the bundle at ``out``, its wall
    time from ``t0`` (default: this call)."""
    from ..retrieval import EmbeddingIndex
    t0 = time.time() if t0 is None else t0
    vecs = np.asarray(engine.run(rows), np.float32)
    index = EmbeddingIndex.build(
        ids=np.arange(rows.shape[0], dtype=np.int64),
        vectors=vecs.reshape(rows.shape[0], -1),
        metric=sc.index_metric, node=sc.node)
    r = warm_retrieval(index, engine, sc.search_k or 10,
                       parse_search_buckets(sc.search_buckets), False)
    if monitor is not None and monitor.enabled:
        monitor.emit("index_build", out=out, rows=index.rows,
                     dim=index.dim, metric=index.metric, node=sc.node,
                     bytes=index.nbytes,
                     wall_ms=(time.time() - t0) * 1e3)
    return r


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
        # retrieval overrides: 0 / "" defer to the bundle's sealed
        # search contract
        self.search_k = 0
        self.search_buckets = ""
        # the metric an index built from this config uses (build_index,
        # continual_index_rows)
        self.index_metric = "dot"
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
            if name == "search_k":
                self.search_k = int(val)
            if name == "search_buckets":
                self.search_buckets = val
            if name == "index_metric":
                self.index_metric = val
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
            engine = build_engine(cfg, model_path, buckets=c.buckets,
                                  max_batch=c.max_batch, node=c.node,
                                  device=device, monitor=monitor)
        self.engine = engine
        # a bundle that seals an embedding index gets a retrieval engine
        # beside the predictor (attached after the weights froze, so the
        # budget counts them): one session, so a hot-swap flips model
        # and index as one pair
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
            if model_path:
                self._attach_index(model_path)
        except BaseException:
            self.batcher.close(drain=False)
            raise

    def _attach_index(self, model_path: str) -> None:
        """Load the bundle's sealed index (digest-verified) into a warmed
        :class:`~cxxnet_tpu_torch.retrieval.engine.RetrievalEngine` on
        the engine's device. No-op for snapshots and index-less
        bundles. Explicit ``search_k`` / ``search_buckets`` win over the
        sealed contract."""
        from ..artifact import bundle as _ab
        if not _ab.is_bundle(model_path):
            return
        man = _ab.bundle_manifest(model_path)
        entry = man.get("index")
        if entry is None:
            return
        from ..retrieval import EmbeddingIndex
        index = EmbeddingIndex.deserialize(
            _ab.read_index_member(model_path, man))
        c = self.cfg
        retrieval = warm_retrieval(
            index, self.engine, c.search_k or int(entry.get("k", 0)) or 10,
            parse_search_buckets(c.search_buckets, entry.get("buckets")),
            bool(c.warm_run))
        self.retrieval = retrieval
        self.index_bytes = index.nbytes

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
