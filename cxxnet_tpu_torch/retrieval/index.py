"""The embedding index artifact: ids + corpus vectors + metric (the
port's own copy of ``cxxnet_tpu/retrieval/index.py``, which is numpy
only; importing it would run ``cxxnet_tpu/__init__.py`` and so JAX).

An :class:`EmbeddingIndex` is the host-side value the retrieval
subsystem builds (``task = build_index`` streams an iterator through
the frozen extract net), seals into the model bundle beside the
weights (``artifact.bundle.export_bundle(..., retrieval=...)``), and
the serve path loads back at boot to feed the device-resident search
engine (:mod:`cxxnet_tpu_torch.retrieval.engine`).

Design decisions pinned here, as in the reference:

- **Exact, not approximate** — the engine scores every corpus row and
  takes an exact top-k; :func:`oracle_topk` is the numpy reference.
  It sorts ``-scores`` stably, so it ranks +0 and -0 as equal, where
  the engines order +0 above -0 (IEEE total order, as
  ``jax.lax.top_k`` does).
- **Cosine normalizes at build time** — the corpus matrix is L2-
  normalized once when ``metric="cosine"``, so the served search only
  normalizes the (tiny) query side per request and dot/cosine share
  one matmul + top-k.
- **Serialization is a plain ``.npz``** — ids (int64), vectors
  (float32), and a JSON metadata record; no pickle, so the member is
  safe to load from an untrusted bundle and the bundle manifest's
  digest covers it exactly like the weight snapshot. The bytes are the
  reference's, so an index crosses packages both ways.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

# the bundle member name the index serializes under (beside
# snapshot.model.npz); the reference's doc/retrieval.md "Index format"
INDEX_MEMBER = "index.embed.npz"

METRICS = ("dot", "cosine")

# cosine guard: a zero embedding row normalizes against this floor
# instead of dividing by zero (the row then scores ~0 everywhere)
_NORM_EPS = 1e-12


class IndexError_(ValueError):
    """A malformed index payload or build input (typed so the serve
    boot path can reject a corrupt bundle member with a clear code
    instead of an arbitrary numpy exception)."""


def l2_normalize(vectors: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization with a zero-row guard."""
    norms = np.linalg.norm(vectors, axis=1, keepdims=True)
    return vectors / np.maximum(norms, _NORM_EPS)


class EmbeddingIndex:
    """An immutable (ids, vectors, metric, node, meta) corpus.

    ``vectors`` is float32 ``(rows, dim)``; with ``metric="cosine"``
    the rows are already L2-normalized (see :meth:`build`). ``ids`` is
    int64 ``(rows,)`` — the external identifiers search results report
    (row order in the build stream by default). ``node`` records which
    net node produced the embeddings, so a query embedded through a
    different node is a config error, not a silent similarity drop.
    """

    __slots__ = ("ids", "vectors", "metric", "node", "meta")

    def __init__(self, ids: np.ndarray, vectors: np.ndarray,
                 metric: str, node: str = "",
                 meta: Optional[Dict[str, Any]] = None):
        self.ids = ids
        self.vectors = vectors
        self.metric = metric
        self.node = node
        self.meta = dict(meta or {})

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, ids, vectors, metric: str = "dot", node: str = "",
              meta: Optional[Dict[str, Any]] = None) -> "EmbeddingIndex":
        """Validate + canonicalize a raw (ids, vectors) pair into an
        index: float32 vectors, int64 ids, cosine rows normalized."""
        if metric not in METRICS:
            raise IndexError_(
                "index_metric must be one of %r, got %r"
                % (METRICS, metric))
        vec = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vec.ndim != 2 or vec.shape[0] < 1 or vec.shape[1] < 1:
            raise IndexError_(
                "index vectors must be a non-empty (rows, dim) "
                "matrix, got shape %r" % (np.shape(vectors),))
        idarr = np.ascontiguousarray(np.asarray(ids, np.int64)).ravel()
        if idarr.shape[0] != vec.shape[0]:
            raise IndexError_(
                "index has %d ids for %d vector rows"
                % (idarr.shape[0], vec.shape[0]))
        if not np.all(np.isfinite(vec)):
            raise IndexError_("index vectors contain non-finite values")
        if metric == "cosine":
            vec = l2_normalize(vec)
        return cls(idarr, vec, metric, node, meta)

    # -- shape/accounting -------------------------------------------------

    @property
    def rows(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def nbytes(self) -> int:
        """Device-resident footprint of the corpus matrix (the number
        that rides the ``serve_device_mem_budget`` books; ids stay on
        the host)."""
        return int(self.vectors.nbytes)

    # -- serialization ----------------------------------------------------

    def serialize(self) -> bytes:
        """The ``index.embed.npz`` member payload: ids + vectors +
        one JSON metadata record. No pickle anywhere."""
        rec = {"metric": self.metric, "node": self.node,
               "rows": self.rows, "dim": self.dim, "meta": self.meta}
        buf = io.BytesIO()
        np.savez(buf, ids=self.ids, vectors=self.vectors,
                 meta=np.frombuffer(
                     json.dumps(rec, sort_keys=True).encode("utf-8"),
                     dtype=np.uint8))
        return buf.getvalue()

    @classmethod
    def deserialize(cls, blob: bytes) -> "EmbeddingIndex":
        try:
            z = np.load(io.BytesIO(blob), allow_pickle=False)
            with z:
                ids = np.asarray(z["ids"], np.int64)
                vec = np.asarray(z["vectors"], np.float32)
                rec = json.loads(bytes(z["meta"]).decode("utf-8"))
        except IndexError_:
            raise
        except Exception as e:
            raise IndexError_("unreadable index payload: %s" % e)
        metric = rec.get("metric", "dot")
        if metric not in METRICS:
            raise IndexError_("index metric %r unknown" % (metric,))
        if vec.ndim != 2 or ids.ndim != 1 \
                or ids.shape[0] != vec.shape[0]:
            raise IndexError_(
                "index payload shape mismatch: ids %r vectors %r"
                % (ids.shape, vec.shape))
        if int(rec.get("rows", vec.shape[0])) != vec.shape[0] \
                or int(rec.get("dim", vec.shape[1])) != vec.shape[1]:
            raise IndexError_(
                "index metadata disagrees with payload shape")
        # cosine rows were normalized at build; do NOT re-normalize
        # (float drift would desync the sealed digest from the math)
        return cls(ids, vec, metric, rec.get("node", ""),
                   rec.get("meta") or {})

    def manifest_entry(self) -> Dict[str, Any]:
        """The bundle manifest's ``index`` block (shape + metric; the
        byte/digest accounting lives in the members table like every
        other member)."""
        return {"member": INDEX_MEMBER, "metric": self.metric,
                "node": self.node, "rows": self.rows, "dim": self.dim}


def oracle_topk(index: EmbeddingIndex, queries: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy exact top-k reference: ``(ids, scores)``, equal scores
    lowest corpus row first (a stable sort of ``-scores``, so +0 and -0
    tie). The parity bar the engine is tested against away from signed
    zeros."""
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if index.metric == "cosine":
        q = l2_normalize(q)
    scores = q @ index.vectors.T
    k = min(int(k), index.rows)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, order, axis=1)
    return index.ids[order], top
