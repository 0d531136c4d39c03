"""The Python API: ``DataIter``, ``Net`` and ``train`` (counterpart of
``cxxnet_tpu/wrapper.py``, the surface of the original cxxnet's
``wrapper/cxxnet.py``).

At this boundary 4-D batches are ``(batch, channel, height, width)``
(NCHW) float32 numpy arrays and labels ``(batch, label_width)``, as in
the reference; inside, spatial nodes are NHWC, and the conversion
happens here, once.

``Net(dev=...)`` runs on the GPU for any device name but ``"cpu"``:
``"tpu"`` (the reference's default), ``"gpu"``, ``"gpu:<n>"``,
``"cuda"``. Without a GPU such a net raises; it never carries on on the
CPU. ``monitor`` keys in ``cfg`` (or given through ``set_param`` before
``init_model`` / ``load_model``) attach a telemetry monitor to the
net's trainer: ``step``, ``eval`` and the model records go to its sink,
``start_round`` opens a ``monitor_trace_dir`` window, and ``close``
drains the sink.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .device import resolve_device
from .io import create_iterator
from .io.data import DataBatch
from .monitor import Monitor, create_monitor, run_metadata
from .nnet.trainer import NetTrainer
from .serve.bucketing import bucket_ladder, pad_to_bucket, pick_bucket
from .utils.config import parse_config, split_sections


def _nchw_to_internal(data: np.ndarray, is_mat: bool) -> np.ndarray:
    """(b,c,h,w) user array -> internal NHWC / (b,features) layout."""
    data = np.asarray(data, np.float32)
    if data.ndim != 4:
        raise ValueError(
            "need a 4 dimensional tensor (batch, channel, height, width)")
    if is_mat:
        b, c, h, w = data.shape
        if c == 1 and h == 1:
            return data.reshape(b, w)
        return data.reshape(b, -1)
    return np.transpose(data, (0, 2, 3, 1))


def _internal_to_nchw(data: np.ndarray) -> np.ndarray:
    """internal NHWC / (b,features) -> (b,c,h,w) user array."""
    data = np.asarray(data)
    if data.ndim == 2:
        return data.reshape(data.shape[0], 1, 1, data.shape[1])
    return np.transpose(data, (0, 3, 1, 2))


class DataIter:
    """A data iterator from config text holding one iterator block, e.g.::

        iter = mnist
        path_img = ...
        iter = end

    and the batch keys (``batch_size``, ``input_shape``,
    ``label_width``)."""

    def __init__(self, cfg: str):
        pairs = parse_config(cfg)
        blocks, global_cfg = split_sections(pairs)
        if not blocks:
            raise ValueError("DataIter config contains no iterator block")
        if len(blocks) > 1:
            raise ValueError("DataIter config must contain exactly one "
                             "iterator block")
        batch_cfg = [(k, v) for k, v in global_cfg
                     if k in ("batch_size", "input_shape", "label_width")]
        self._it = create_iterator(blocks[0]["cfg"], batch_cfg)
        self._it.init()
        self.head = True
        self.tail = False

    def next(self) -> bool:
        ok = self._it.next()
        self.head = False
        self.tail = not ok
        return ok

    def before_first(self) -> None:
        self._it.before_first()
        self.head = True
        self.tail = False

    def check_valid(self) -> None:
        if self.head:
            raise RuntimeError(
                "iterator was at head state, call next to get to valid "
                "state")
        if self.tail:
            raise RuntimeError("iterator reaches end")

    @property
    def batch(self) -> DataBatch:
        self.check_valid()
        return self._it.value()

    def get_data(self) -> np.ndarray:
        """Current batch data in (batch, channel, height, width)."""
        return _internal_to_nchw(self.batch.data)

    def get_label(self) -> np.ndarray:
        """Current batch label (batch, label_width)."""
        lab = np.asarray(self.batch.label, np.float32)
        if lab.ndim == 1:
            lab = lab.reshape(-1, 1)
        return lab

    def close(self) -> None:
        """Stop the iterator's threads (prefetch, decode)."""
        self._it.close()

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.batch


class Net:
    """A neural net from config text (the netconfig block and the
    globals) on the device ``dev`` names (see the module docstring)."""

    def __init__(self, dev: str = "tpu", cfg: str = ""):
        self.device = resolve_device(
            "cpu" if dev.split(":")[0] == "cpu" else "cuda")
        self._cfg = parse_config(cfg) if cfg else []
        if self._cfg:
            self._validate_netconfig(self._cfg)
        self._extra: List[Tuple[str, str]] = []
        self._trainer: Optional[NetTrainer] = None
        self._mon = Monitor()
        self._round = 0
        self._pred_buckets = None        # pred-shape ladder, built lazily

    @staticmethod
    def _validate_netconfig(cfg) -> None:
        """Reject a bad structure or layer type at creation, as the
        reference (whose C ABI returns NULL from ``CXNNetCreate``)."""
        from .graph import NetGraph
        from .layers import known_layer_type
        g = NetGraph()
        g.configure(cfg)
        for li, info in enumerate(g.layers):
            if info.type == "share":
                continue
            if not known_layer_type(info.type):
                raise ValueError("unknown layer type %r (layer %d)"
                                 % (info.type, li))

    # -- config / lifecycle ---------------------------------------------

    def set_param(self, name, value) -> None:
        self._extra.append((str(name), str(value)))

    def _make_trainer(self) -> NetTrainer:
        if self._trainer is None:
            cfg = list(self._cfg) + self._extra
            self._trainer = NetTrainer(cfg, device=self.device)
            self._mon = create_monitor(cfg)
            if self._mon.enabled:
                self._mon.emit("run_start", **run_metadata(
                    "wrapper", cfg, self.device))
            self._trainer.set_monitor(self._mon)
        return self._trainer

    def init_model(self) -> None:
        self._make_trainer().init_model()

    def load_model(self, fname: str) -> None:
        self._make_trainer().load_model(fname)

    def save_model(self, fname: str) -> None:
        self._req().save_model(fname)

    def _req(self) -> NetTrainer:
        if self._trainer is None or not self._trainer._initialized:
            raise RuntimeError("call init_model or load_model first")
        return self._trainer

    def start_round(self, round_counter: int) -> None:
        """Open round ``round_counter``: its counter window and, under
        ``monitor_trace_dir``, the trace window's rounds."""
        t = self._req()
        self._mon.maybe_stop_trace(self._round)
        self._round = round_counter
        if self._mon.enabled:
            self._mon.emit("round_start", round=round_counter)
        self._mon.maybe_start_trace(round_counter)
        t.start_round(round_counter)

    def counters(self) -> Dict[str, float]:
        """Training progress for polling callers: ``steps`` (update
        dispatches), ``examples`` (real rows consumed) and
        ``last_round_examples_per_sec`` (the last closed
        ``start_round`` window). Host-side numbers only: no device
        sync."""
        return self._req().counters_snapshot()

    def close(self) -> None:
        """Stop an open trace window and drain the monitor's sink."""
        self._mon.close()

    # -- data plumbing ---------------------------------------------------

    def _to_batch(self, data, label=None) -> DataBatch:
        if isinstance(data, DataIter):
            return data.batch
        data = np.asarray(data, np.float32)
        t = self._req()
        is_mat = t.net.node_shapes[0].is_mat
        arr = _nchw_to_internal(data, is_mat)
        if label is not None:
            label = np.asarray(label, np.float32)
            if label.ndim == 1:
                label = label.reshape(-1, 1)
            if label.ndim != 2:
                raise ValueError("label must be 1-D or 2-D")
            if label.shape[0] != arr.shape[0]:
                raise ValueError("Net.update: data size mismatch")
        return DataBatch(data=arr, label=label)

    def _bucket_pred_batch(self, batch: DataBatch) -> DataBatch:
        """Round a pred/extract batch up to its bucket of the
        ``batch_size`` ladder (the serve ladder; the port has no mesh,
        so its alignment is 1): varying caller sizes meet a handful of
        shapes, each with its first-use costs paid once. Padded rows
        ride the ``num_batch_padd`` mask and are cut from the result;
        an iterator batch that is padded already passes through."""
        if batch.num_batch_padd:
            return batch
        t = self._req()
        if self._pred_buckets is None:
            self._pred_buckets = bucket_ladder(t.batch_size, align=1)
        n = batch.batch_size
        bucket = pick_bucket(n, self._pred_buckets, extend=True)
        if bucket == n:
            return batch
        data, npad = pad_to_bucket(np.asarray(batch.data), bucket)
        label = batch.label
        if label is not None:
            label, _ = pad_to_bucket(np.asarray(label), bucket)
        return DataBatch(
            data=data, label=label, num_batch_padd=npad,
            extra_data=[pad_to_bucket(np.asarray(e), bucket)[0]
                        for e in batch.extra_data])

    # -- training / inference --------------------------------------------

    def update(self, data, label=None):
        """One training step on a batch (DataIter or NCHW ndarray+label)."""
        if isinstance(data, np.ndarray) and label is None:
            raise ValueError("Net.update: need label to use update")
        self._req().update(self._to_batch(data, label))

    def evaluate(self, data, name: str) -> str:
        """Full eval pass over a DataIter; returns the metric string."""
        if not isinstance(data, DataIter):
            raise TypeError("evaluate needs a DataIter")
        return self._req().evaluate(iter(data), name)

    def predict(self, data) -> np.ndarray:
        """Predicted class index (or scalar output) per row; inputs pad
        to a batch-size bucket."""
        batch = data.batch if isinstance(data, DataIter) \
            else self._to_batch(data)
        return self._req().predict(self._bucket_pred_batch(batch))

    def extract(self, data, name: str) -> np.ndarray:
        """A named node's activations (``top[-k]`` too), NCHW; flat nodes
        as (b, 1, 1, f). Bucket-padded like :meth:`predict`."""
        batch = data.batch if isinstance(data, DataIter) \
            else self._to_batch(data)
        out = self._req().extract_feature(self._bucket_pred_batch(batch),
                                          name)
        return _internal_to_nchw(out)

    # -- weights ---------------------------------------------------------

    def set_weight(self, weight: np.ndarray, layer_name: str,
                   tag: str) -> None:
        if tag not in ("bias", "wmat"):
            raise ValueError("tag must be bias or wmat")
        t = self._req()
        weight = np.asarray(weight, np.float32)
        cur = t.get_weight(layer_name, tag)     # reference-layout shape
        if weight.shape != cur.shape:
            if weight.size != cur.size:
                raise ValueError(
                    "set_weight %s:%s: size %d does not match %d"
                    % (layer_name, tag, weight.size, cur.size))
            weight = weight.reshape(cur.shape)  # flat C-ABI input
        t.set_weight(layer_name, tag, weight)

    def get_weight(self, layer_name: str, tag: str) -> Optional[np.ndarray]:
        if tag not in ("bias", "wmat"):
            raise ValueError("tag must be bias or wmat")
        t = self._req()
        if layer_name not in t.params or tag not in t.params[layer_name]:
            return None
        return t.get_weight(layer_name, tag)


def train(cfg: str, data, num_round: int, param, eval_data=None,
          label=None, dev: str = "tpu") -> Net:
    """Train a net from config text (the reference's ``train``): ``data``
    is a DataIter, or an NCHW ndarray with ``label``; ``param`` a dict
    or (key, value) pairs applied through ``set_param``; ``dev`` as for
    :class:`Net`."""
    net = Net(dev=dev, cfg=cfg)
    if isinstance(param, dict):
        param = param.items()
    for k, v in param:
        net.set_param(k, v)
    net.init_model()
    if isinstance(data, DataIter):
        for r in range(num_round):
            net.start_round(r)
            data.before_first()
            scounter = 0
            while data.next():
                net.update(data)
                scounter += 1
                if scounter % 100 == 0:
                    print("[%d] %d batch passed" % (r, scounter))
            if eval_data is not None:
                seval = net.evaluate(eval_data, "eval")
                print("[%d]%s" % (r, seval))
    else:
        if label is None:
            raise ValueError("train from ndarray needs label=")
        for r in range(num_round):
            net.start_round(r)
            net.update(data=data, label=label)
    return net
