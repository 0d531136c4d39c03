"""Device-resident embedding retrieval: exact top-k over a corpus
embedded through the frozen extract net (counterpart of
``cxxnet_tpu/retrieval/``).

``task = build_index`` builds the :class:`EmbeddingIndex` and seals it
into the model bundle beside the weights; the serve path loads it back
into a :class:`RetrievalEngine` on the session's device, so
``/v1/embed`` and ``/v1/search`` answer from one session, and a
hot-swap flips model and index as one pair.
"""

from .engine import DEFAULT_K, RetrievalEngine, self_recall
from .index import (INDEX_MEMBER, METRICS, EmbeddingIndex, IndexError_,
                    l2_normalize, oracle_topk)

__all__ = [
    "DEFAULT_K", "EmbeddingIndex", "INDEX_MEMBER", "IndexError_",
    "METRICS", "RetrievalEngine", "l2_normalize", "oracle_topk",
    "self_recall",
]
