"""The port's retrieval engine and index (``cxxnet_tpu_torch/retrieval``)
against the reference's (``cxxnet_tpu/retrieval``), on the CPU.

The same seeded numpy corpora and queries go through both packages:

- an index built, serialized and deserialized by either package is the
  other's, byte for byte, and both ``oracle_topk`` give the same ids
  and scores;
- the port's engine returns the reference engine's ids exactly, and
  its scores within rtol 1e-6 / atol 1e-6 (float32 dot products of at
  most 48 terms summed in another order by XLA and oneDNN; cosine
  normalizes the query in each framework). The ids are compared
  exactly on random data, on planted exact duplicates, on an all-zero
  query (every score +0 or -0: the engines rank +0 above -0, lowest row
  first, which the numpy oracle does not) and on integer-valued rows
  whose products and sums are exact in float32;
- ``k`` and shape validation, the budget's typed rejection (before a
  corpus byte reaches the device) and the counters after warmup, as
  the reference's.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.artifact.registry import ProgramRegistry
from cxxnet_tpu.artifact.registry import \
    ResidencyBudgetError as RefBudgetError
from cxxnet_tpu.retrieval import EmbeddingIndex as RefIndex
from cxxnet_tpu.retrieval import IndexError_ as RefIndexError
from cxxnet_tpu.retrieval import RetrievalEngine as RefEngine
from cxxnet_tpu.retrieval import oracle_topk as ref_oracle
from cxxnet_tpu.retrieval import self_recall as ref_self_recall
from cxxnet_tpu_torch import retrieval as pr
from cxxnet_tpu_torch.artifact.registry import ResidencyBudgetError
from cxxnet_tpu_torch.retrieval.engine import exact_topk, exact_topk_sort

SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-6


def _corpus(kind, rows=200, dim=48, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randn(rows, dim).astype(np.float32)
    if kind == "duplicates":
        v = rng.randn(rows, dim).astype(np.float32)
        v[50:60] = v[7]                  # ten exact copies of row 7
        v[150] = v[3]
        return v
    # integer-valued: every product and sum exact in float32
    return rng.randint(-4, 5, (rows, dim)).astype(np.float32)


def _queries(kind, corpus, n=5, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randn(n, corpus.shape[1]).astype(np.float32)
    if kind == "duplicates":
        q = corpus[[7, 3, 11, 55, 150]].copy()
        q[2] = 0.0                       # every score +0 or -0
        return q
    return rng.randint(-3, 4, (n, corpus.shape[1])).astype(np.float32)


def _engines(vectors, metric, k, buckets=(1, 4, 8)):
    ids = np.arange(1000, 1000 + vectors.shape[0])
    ri = RefIndex.build(ids, vectors, metric=metric)
    pi = pr.EmbeddingIndex.build(ids, vectors, metric=metric)
    re_ = RefEngine(ri, ProgramRegistry(), k=k, buckets=buckets)
    pe = pr.RetrievalEngine(pi, "cpu", k=k, buckets=buckets)
    re_.warmup()
    pe.warmup()
    return ri, pi, re_, pe


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_index_crosses_packages_byte_for_byte(metric):
    v = _corpus("random", rows=30, dim=6)
    ri = RefIndex.build(np.arange(30), v, metric=metric, node="flat",
                        meta={"src": "x"})
    pi = pr.EmbeddingIndex.build(np.arange(30), v, metric=metric,
                                 node="flat", meta={"src": "x"})
    np.testing.assert_array_equal(pi.vectors, ri.vectors)
    assert pi.serialize() == ri.serialize()
    assert pi.manifest_entry() == ri.manifest_entry()
    assert pi.nbytes == ri.nbytes
    back = pr.EmbeddingIndex.deserialize(ri.serialize())
    again = RefIndex.deserialize(pi.serialize())
    for idx in (back, again):
        np.testing.assert_array_equal(idx.vectors, ri.vectors)
        np.testing.assert_array_equal(idx.ids, ri.ids)
        assert (idx.metric, idx.node, idx.meta) == (metric, "flat",
                                                    {"src": "x"})


@pytest.mark.parametrize("blob", [b"corpus", b""])
def test_malformed_payload_is_typed_in_both(blob):
    with pytest.raises(pr.IndexError_) as pe:
        pr.EmbeddingIndex.deserialize(blob)
    with pytest.raises(RefIndexError) as re_:
        RefIndex.deserialize(blob)
    assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("bad", ["metric", "shape", "ids", "nan"])
def test_build_validation_matches(bad):
    v = _corpus("random", rows=4, dim=3)
    args = {"ids": np.arange(4), "vectors": v, "metric": "dot"}
    if bad == "metric":
        args["metric"] = "l2"
    elif bad == "shape":
        args["vectors"] = v[0]
    elif bad == "ids":
        args["ids"] = np.arange(3)
    else:
        args["vectors"] = v.copy()
        args["vectors"][1, 1] = np.nan
    with pytest.raises(pr.IndexError_) as pe:
        pr.EmbeddingIndex.build(**args)
    with pytest.raises(RefIndexError) as re_:
        RefIndex.build(**args)
    assert str(pe.value) == str(re_.value)


@pytest.mark.parametrize("kind", ["random", "duplicates", "integers"])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_oracle_topk_matches(kind, metric):
    v = _corpus(kind)
    q = _queries(kind, v)
    ri = RefIndex.build(np.arange(200), v, metric=metric)
    pi = pr.EmbeddingIndex.build(np.arange(200), v, metric=metric)
    for a, b in zip(pr.oracle_topk(pi, q, 7), ref_oracle(ri, q, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "duplicates", "integers"])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_engine_ids_equal_reference(kind, metric):
    """Queries of 1, 3 (padded into bucket 4) and 5 (bucket 8) rows."""
    v = _corpus(kind)
    q = _queries(kind, v)
    _, _, re_, pe = _engines(v, metric, k=12)
    for rows in (q[:1], q[:3], q):
        for k in (None, 1, 12):
            rid, rsc = re_.search(rows, k=k)
            pid, psc = pe.search(rows, k=k)
            np.testing.assert_array_equal(pid, rid)
            assert psc.dtype == np.float32
            np.testing.assert_allclose(psc, rsc, rtol=SCORE_RTOL,
                                       atol=SCORE_ATOL)
            if kind == "integers" and metric == "dot":
                # exact scores: the same bits
                np.testing.assert_array_equal(psc.view(np.int32),
                                              rsc.view(np.int32))


def test_signed_zero_order_is_the_reference_engines():
    """[0, -0, 0, -0, 1, 1]: jax.lax.top_k's rows 4, 5, 0, 2, 1, 3 (+0
    above -0, lowest row first); numpy's stable oracle ranks the zeros
    as equal (0, 1, 2, 3). The plain sort version agrees with the
    top-k."""
    s = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, 1.0]])
    for fn in (exact_topk, exact_topk_sort):
        vals, cols = fn(s, 6)
        assert cols.tolist() == [[4, 5, 0, 2, 1, 3]]
        assert torch.equal(vals.view(torch.int32),
                           s[:, [4, 5, 0, 2, 1, 3]].view(torch.int32))
    # an all-zero query through both engines: every row holds a positive
    # entry, so each sum meets a +0 product and is +0 in both frameworks
    # (a lone -0 product is -0 in XLA's dot and +0 in a BLAS sum that
    # starts from +0: the scores' signed zeros are the frameworks', the
    # order over them the same), and all rows tie, lowest first
    v = np.array([[1.0, -1.0], [-1.0, 2.0], [2.0, 1.0], [-3.0, 0.5]],
                 np.float32)
    _, _, re_, pe = _engines(v, "dot", k=4, buckets=(1,))
    q = np.zeros((1, 2), np.float32)
    rid, rsc = re_.search(q)
    pid, psc = pe.search(q)
    np.testing.assert_array_equal(pid, rid)
    np.testing.assert_array_equal(psc.view(np.int32), rsc.view(np.int32))
    assert pid.tolist() == [[1000, 1001, 1002, 1003]]


def test_topk_and_sort_agree_on_random_scores():
    g = torch.Generator().manual_seed(0)
    s = torch.randn(9, 333, generator=g).round()     # many ties
    s[3] = 0.0
    s[4, ::2] = -0.0
    a, b = exact_topk(s, 40), exact_topk_sort(s, 40)
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))


def test_k_and_shape_validation_match():
    v = _corpus("random", rows=6, dim=4)
    _, _, re_, pe = _engines(v, "dot", k=3, buckets=(2,))
    for args in ((np.zeros((1, 4)), 4), (np.zeros((1, 4)), 0),
                 (np.zeros((1, 5)), None), (np.zeros((0, 4)), None)):
        with pytest.raises(ValueError) as pe_err:
            pe.search(*args)
        with pytest.raises(ValueError) as re_err:
            re_.search(*args)
        assert str(pe_err.value) == str(re_err.value)
    assert pr.RetrievalEngine(pe.index, "cpu", k=99).k == 6
    assert pr.RetrievalEngine(pe.index, "cpu").buckets \
        == RefEngine(re_.index, ProgramRegistry()).buckets


def test_budget_rejects_before_the_corpus_moves():
    v = _corpus("random", rows=16, dim=4)
    pi = pr.EmbeddingIndex.build(np.arange(16), v)
    ri = RefIndex.build(np.arange(16), v)
    pe = pr.RetrievalEngine(pi, "cpu", k=2, buckets=(1,))
    with pytest.raises(ResidencyBudgetError) as e:
        pe.warmup(budget_bytes=pi.nbytes - 1)
    assert pe._corpus is None
    re_ = RefEngine(ri, ProgramRegistry(), k=2, buckets=(1,))
    with pytest.raises(RefBudgetError) as re_err:
        re_.warmup(budget_bytes=ri.nbytes - 1)
    assert str(e.value) == str(re_err.value)
    with pytest.raises(ResidencyBudgetError, match="weights \\(100 bytes"):
        pe.warmup(budget_bytes=pi.nbytes + 50, weight_bytes=100)
    assert pe.warmup(budget_bytes=pi.nbytes) == 1


def test_counters_and_describe_after_warmup():
    v = _corpus("random", rows=40, dim=8)
    _, _, re_, pe = _engines(v, "cosine", k=4, buckets=(1, 4))
    for e in (re_, pe):
        assert e.counters_snapshot() == {
            "dispatches": 0, "queries": 0, "pad_rows": 0, "aot_hits": 0,
            "compile_events": 0}
        e.search(np.ones((3, 8), np.float32))
        e.search(np.ones((6, 8), np.float32))    # chunks 4 + 2
    assert pe.counters_snapshot() == re_.counters_snapshot()
    assert pe.counters_snapshot()["compile_events"] == 0
    assert pe.describe() == re_.describe()
    assert pr.self_recall(pe) == ref_self_recall(re_) == 1.0
