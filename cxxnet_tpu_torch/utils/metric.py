"""Evaluation metrics: rmse / error / logloss / rec@n / recall@k /
prec@k (a copy of ``cxxnet_tpu/utils/metric.py``; the port imports
nothing of the JAX package).

Metrics accumulate (sum, count) over instances; ``MetricSet`` binds
each metric to a named label field (``metric[label] = error``) and an
output node; the line format is ``\\t<evname>-<metric>[field]:<value>``.
The port runs in one process, so there is no cross-process reduction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Metric:
    name = "metric"

    def __init__(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def clear(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def _calc(self, pred: np.ndarray, label: np.ndarray) -> np.ndarray:
        """Vectorized per-instance metric: (n,k) preds, (n,w) labels -> (n,)."""
        raise NotImplementedError

    def add_eval(self, pred: np.ndarray, label: np.ndarray) -> None:
        if pred.shape[0] == 0:
            return
        vals = self._calc(np.asarray(pred, np.float32),
                          np.asarray(label, np.float32))
        self.sum_metric += float(np.sum(vals))
        self.cnt_inst += int(pred.shape[0])

    def get(self) -> float:
        c = float(self.cnt_inst)
        return self.sum_metric / c if c > 0 else float("nan")


class MetricRMSE(Metric):
    name = "rmse"

    def _calc(self, pred, label):
        if pred.shape[1] != label.shape[1]:
            raise ValueError("rmse: prediction/label size mismatch")
        return np.sum((pred - label) ** 2, axis=1)


class MetricError(Metric):
    name = "error"

    def _calc(self, pred, label):
        if pred.shape[1] != 1:
            maxidx = np.argmax(pred, axis=1)
        else:
            maxidx = (pred[:, 0] > 0.0).astype(np.int64)
        return (maxidx != label[:, 0].astype(np.int64)).astype(np.float32)


class MetricLogloss(Metric):
    name = "logloss"

    def _calc(self, pred, label):
        eps = 1e-15
        if pred.shape[1] != 1:
            tgt = label[:, 0].astype(np.int64)
            p = np.clip(pred[np.arange(pred.shape[0]), tgt], eps, 1 - eps)
            return -np.log(p)
        p = np.clip(pred[:, 0], eps, 1 - eps)
        y = label[:, 0]
        res = -(y * np.log(p) + (1.0 - y) * np.log(1 - p))
        if np.any(np.isnan(res)):
            raise FloatingPointError("NaN detected in logloss")
        return res


class MetricRecall(Metric):
    """rec@n: fraction of true labels present in the top-n predictions."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        if not name.startswith("rec@"):
            raise ValueError("must specify n for rec@n")
        self.topn = int(name[4:])

    def _calc(self, pred, label):
        if pred.shape[1] < self.topn:
            raise ValueError("rec@%d on a list of %d" %
                             (self.topn, pred.shape[1]))
        # ties broken by index (reference shuffles then stable-sorts;
        # equivalent in distribution, deterministic here)
        top = np.argpartition(-pred, self.topn - 1, axis=1)[:, :self.topn]
        hits = (top[:, :, None] == label[:, None, :].astype(np.int64))
        return hits.any(axis=1).sum(axis=1).astype(np.float32) \
            / label.shape[1]


def _topk_by_index(pred: np.ndarray, k: int) -> np.ndarray:
    """Deterministic top-k prediction columns: scores descending,
    ties broken by lowest column index."""
    order = np.argsort(-pred, axis=1, kind="stable")
    return order[:, :k]


class MetricRecallAtK(Metric):
    """recall@k: |relevant ∩ top-k| / |relevant| per row. Unlike
    ``rec@n``, ``k`` clips to the prediction width, negative label
    entries are padding, and a row with no valid label scores 0."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        if not name.startswith("recall@"):
            raise ValueError("must specify k for recall@k")
        self.topk = int(name[len("recall@"):])
        if self.topk < 1:
            raise ValueError("recall@k needs k >= 1, got %d"
                             % self.topk)

    def _calc(self, pred, label):
        k = min(self.topk, pred.shape[1])
        top = _topk_by_index(pred, k)
        lab = label.astype(np.int64)
        valid = lab >= 0
        hits = (top[:, :, None] == lab[:, None, :]) & valid[:, None, :]
        nrel = valid.sum(axis=1)
        return np.where(
            nrel > 0,
            hits.any(axis=1).sum(axis=1) / np.maximum(nrel, 1),
            0.0).astype(np.float32)


class MetricPrecisionAtK(Metric):
    """prec@k: |relevant ∩ top-k| / k per row, with recall@k's
    conventions (the divisor stays the requested k)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        if not name.startswith("prec@"):
            raise ValueError("must specify k for prec@k")
        self.topk = int(name[len("prec@"):])
        if self.topk < 1:
            raise ValueError("prec@k needs k >= 1, got %d" % self.topk)

    def _calc(self, pred, label):
        k = min(self.topk, pred.shape[1])
        top = _topk_by_index(pred, k)
        lab = label.astype(np.int64)
        valid = lab >= 0
        hits = (top[:, :, None] == lab[:, None, :]) & valid[:, None, :]
        return (hits.any(axis=2).sum(axis=1)
                / float(self.topk)).astype(np.float32)


def create_metric(name: str) -> Optional[Metric]:
    if name == "rmse":
        return MetricRMSE()
    if name == "error":
        return MetricError()
    if name == "logloss":
        return MetricLogloss()
    if name.startswith("recall@"):
        return MetricRecallAtK(name)
    if name.startswith("prec@"):
        return MetricPrecisionAtK(name)
    if name.startswith("rec@"):
        return MetricRecall(name)
    return None


class MetricSet:
    """A set of metrics, each bound to (label field, output node name)."""

    def __init__(self) -> None:
        self.evals: List[Metric] = []
        self.label_fields: List[str] = []
        self.node_names: List[str] = []

    def add_metric(self, name: str, field: str = "label",
                   node: str = "") -> None:
        m = create_metric(name)
        if m is None:
            raise ValueError("unknown metric name %r" % name)
        self.evals.append(m)
        self.label_fields.append(field)
        self.node_names.append(node)

    def clear(self) -> None:
        for m in self.evals:
            m.clear()

    def add_eval(self, preds: Sequence[np.ndarray],
                 label_fields: Dict[str, np.ndarray]) -> None:
        """preds: one prediction matrix per metric (non-padded rows only)."""
        assert len(preds) == len(self.evals)
        for m, field, pred in zip(self.evals, self.label_fields, preds):
            if field not in label_fields:
                raise ValueError("Metric: unknown target = %s" % field)
            m.add_eval(pred, label_fields[field])

    def results(self) -> List[Tuple[str, float]]:
        """[(tag, value)] where tag is ``<metric>[field]`` (field tag
        only when non-default)."""
        out = []
        for m, field in zip(self.evals, self.label_fields):
            tag = m.name if field == "label" \
                else "%s[%s]" % (m.name, field)
            out.append((tag, m.get()))
        return out

    @staticmethod
    def format_line(evname: str,
                    results: List[Tuple[str, float]]) -> str:
        """The eval-line format of the reference,
        ``\\t<evname>-<tag>:<value>`` per metric."""
        return "".join("\t%s-%s:%g" % (evname, tag, v)
                       for tag, v in results)

    def print_str(self, evname: str) -> str:
        return self.format_line(evname, self.results())
