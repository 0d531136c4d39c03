"""The device-resident exact top-k search engine (counterpart of
``cxxnet_tpu/retrieval/engine.py``).

Pairs an :class:`~cxxnet_tpu_torch.retrieval.index.EmbeddingIndex`
with the serving device: the corpus matrix goes to the device once at
warmup, as a float32 tensor, and every dispatch pads its queries to a
bucket of the ladder, scores every corpus row with one ``torch.matmul``
(TF32 off, as everywhere in the port) and takes an exact top-k. There
is no recall knob.

- **the order** is the reference engine's ``jax.lax.top_k``: scores
  descending in IEEE total order (+0 above -0), equal scores lowest
  corpus row first. ``torch.topk`` promises no order among ties, so
  :func:`exact_topk` ranks unique int64 keys instead: each float32
  score mapped to its totally ordered int32 in the high half, ``2^32 -
  1 - row`` in the low half. :func:`exact_topk_sort` is the plain
  version (a stable descending sort of the same keys);
- **the budget**: the index bytes ride the same
  ``serve_device_mem_budget`` books as the frozen weight tree; warmup
  raises :class:`~cxxnet_tpu_torch.artifact.registry.ResidencyBudgetError`
  with the reference's message before a corpus byte reaches the device;
- **the counters** keep the reference's names. Eager PyTorch compiles
  nothing, so a bucket counts as built once warmup has registered it:
  a dispatch there is an ``aot_hit``, the first at any other bucket a
  ``compile_event``. Warmup resets them, so a boot shows zero compile
  events, as the reference's bundle boot does.

The search runs no hand-written kernel: the reference computes it in
XLA, outside Pallas, so a library product and ``torch.topk`` are its
counterparts.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..artifact.registry import ResidencyBudgetError
from ..device import resolve_device
from ..serve.bucketing import bucket_ladder, pick_bucket
from .index import EmbeddingIndex

# default result depth (``search_k``); requests may ask for any k <=
# this
DEFAULT_K = 10

# cosine guard on the query side, as the reference program's
_NORM_EPS = 1e-12

_LOW = 0xFFFFFFFF


def _order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys that sort as the reference's top-k ranks: the
    float32 score's totally ordered int32 in the high half, ``2^32 - 1
    - column`` in the low half."""
    b = scores.contiguous().view(torch.int32)
    ordered = b ^ ((b >> 31) & 0x7FFFFFFF)
    col = torch.arange(scores.shape[1], device=scores.device,
                       dtype=torch.int64)
    return ordered.to(torch.int64) * (1 << 32) + (_LOW - col)


def _columns(top_keys: torch.Tensor) -> torch.Tensor:
    return _LOW - (top_keys & _LOW)


def exact_topk(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, columns)`` of the ``k`` largest scores of each row, in
    the reference's order (see the module docstring)."""
    top = torch.topk(_order_keys(scores), k, dim=1).values
    cols = _columns(top)
    return scores.gather(1, cols), cols


def exact_topk_sort(scores: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`exact_topk`: a stable descending sort
    of the same keys."""
    keys = torch.sort(_order_keys(scores), dim=1, descending=True,
                      stable=True).values[:, :k]
    cols = _columns(keys)
    return scores.gather(1, cols), cols


class RetrievalEngine:
    """Bucketed exact top-k search over one embedding index, on
    ``device`` (the GPU by default). Thread safety mirrors
    :class:`~cxxnet_tpu_torch.serve.engine.InferenceEngine`: the
    dispatch and the counters under one lock, the device-to-host fetch
    outside it."""

    def __init__(self, index: EmbeddingIndex, device=None,
                 k: int = DEFAULT_K,
                 buckets: Optional[Sequence[int]] = None):
        if index.rows < 1:
            raise ValueError("cannot serve an empty index")
        self.index = index
        self.device = resolve_device(device)
        # the result depth; capped at the corpus
        self.k = max(1, min(int(k), index.rows))
        if buckets is None:
            buckets = bucket_ladder(32)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError("query buckets must be >= 1")
        self.max_batch = self.buckets[-1]
        self._lock = threading.Lock()
        self._warm: set = set()          # buckets warmup registered
        self._cold: set = set()          # buckets first seen by traffic
        self._corpus: Optional[torch.Tensor] = None
        self.counters: Dict[str, int] = {
            "dispatches": 0, "queries": 0, "pad_rows": 0,
            "aot_hits": 0, "compile_events": 0}

    # -- warmup -----------------------------------------------------------

    def warmup(self, warm_run: bool = True, budget_bytes: int = 0,
               weight_bytes: int = 0) -> int:
        """Check the residency budget (``weight_bytes`` of the model's
        frozen tree + the index against ``budget_bytes``; 0 = none),
        copy the corpus to the device, register the bucket ladder and,
        with ``warm_run``, run each bucket once on zero queries. Returns
        the number of buckets registered; the counters reset
        afterwards."""
        total = int(weight_bytes) + self.index.nbytes
        if budget_bytes and total > budget_bytes:
            raise ResidencyBudgetError(
                "weights (%d bytes) + embedding index (%d bytes) need "
                "%d resident bytes but serve_device_mem_budget allows "
                "%d" % (weight_bytes, self.index.nbytes, total,
                        budget_bytes))
        self._corpus = torch.from_numpy(
            np.ascontiguousarray(self.index.vectors, np.float32)) \
            .to(self.device)
        self._warm = set(self.buckets)
        if warm_run:
            for b in self.buckets:
                self.search(np.zeros((b, self.index.dim), np.float32))
        with self._lock:
            self._cold.clear()
            for c in self.counters:
                self.counters[c] = 0
        return len(self._warm)

    # -- search -----------------------------------------------------------

    def search(self, queries: np.ndarray,
               k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the corpus: ``(ids, scores)`` with shapes
        ``(n, k)``. ``k`` defaults to the engine's depth and may be any
        value ``1..self.k``; anything else raises ``ValueError``."""
        if self._corpus is None:
            raise RuntimeError("RetrievalEngine.warmup() not called")
        want = self.k if k is None else int(k)
        if not 1 <= want <= self.k:
            raise ValueError(
                "k=%d outside the served range 1..%d (search_k pins "
                "the compiled result depth)" % (want, self.k))
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.index.dim:
            raise ValueError(
                "query shape %r does not match the index dim %d"
                % (np.shape(queries), self.index.dim))
        if q.shape[0] < 1:
            raise ValueError("search() needs at least one query row")
        ids_out, sc_out = [], []
        for i in range(0, q.shape[0], self.max_batch):
            ids, sc = self._dispatch(q[i:i + self.max_batch], want)
            ids_out.append(ids)
            sc_out.append(sc)
        if len(ids_out) == 1:
            return ids_out[0], sc_out[0]
        return (np.concatenate(ids_out, axis=0),
                np.concatenate(sc_out, axis=0))

    def _scores(self, q: torch.Tensor) -> torch.Tensor:
        """The bucket's score matrix: the query side normalized under
        cosine (the corpus was at build), then one product."""
        if self.index.metric == "cosine":
            norm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
            q = q / torch.clamp(norm, min=_NORM_EPS)
        return torch.matmul(q, self._corpus.t())

    def _dispatch(self, q: np.ndarray, want: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        n = q.shape[0]
        bucket = pick_bucket(n, self.buckets)
        if n < bucket:
            q = np.concatenate(
                [q, np.zeros((bucket - n, q.shape[1]), np.float32)],
                axis=0)
        with self._lock:
            if bucket in self._warm:
                self.counters["aot_hits"] += 1
            elif bucket not in self._cold:
                self._cold.add(bucket)
                self.counters["compile_events"] += 1
            qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
            vals, cols = exact_topk(self._scores(qd), self.k)
        # the fetch waits for the device: outside the lock
        scores = vals[:n, :want].cpu().numpy()
        rowidx = cols[:n, :want].cpu().numpy()
        with self._lock:
            self.counters["dispatches"] += 1
            self.counters["queries"] += n
            self.counters["pad_rows"] += bucket - n
        return self.index.ids[rowidx], scores.astype(np.float32)

    # -- helpers ----------------------------------------------------------

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def describe(self) -> Dict[str, object]:
        snap = self.counters_snapshot()
        snap.update({"rows": self.index.rows, "dim": self.index.dim,
                     "metric": self.index.metric, "k": self.k,
                     "index_bytes": self.index.nbytes,
                     "buckets": list(self.buckets)})
        return snap


def self_recall(engine: RetrievalEngine, sample: int = 8) -> float:
    """Spot-check recall: query the index with its own first ``sample``
    corpus rows; each must retrieve itself at rank 1 (exact search, a
    duplicate-free corpus). The ``retrieval`` record's ``recall``."""
    n = min(int(sample), engine.index.rows)
    q = engine.index.vectors[:n]
    ids, _ = engine.search(q, k=1)
    hits = int(np.sum(ids[:, 0] == engine.index.ids[:n]))
    return hits / float(n)
