"""NetTrainer (counterpart of ``cxxnet_tpu/nnet/trainer.py``).

What is ported: model init and snapshot load/save (optimizer state
too, under ``save_optimizer = 1``), training (``update``,
``run_steps``, ``update_many`` with ``update_period`` accumulation,
one updater per (layer, tag), train and eval metrics), the one-time
freeze of the eval weights (``freeze_serve_weights``), the eval forward
behind ``predict`` / ``extract_feature``, the reference-layout
weight get/set, the finetune carry (``finetune_from``,
``copy_model_from``, ``load_weights_inplace``), ``precompile`` and the
telemetry records (``set_monitor``).

A training step is the reference's ``scan_step`` written eagerly:
autograd over ``FuncNet.loss_fn`` in place of ``jax.value_and_grad``,
then the updaters; the schedule is evaluated on the host per step.
Stochastic layers (dropout) draw for the step's ``(seed, global sample
step)``, so ``update``, ``update_many`` and ``run_steps`` give one batch
sequence the same masks.

Mixed precision, the reference's keys: ``dtype = bfloat16`` runs the
convs and fullc layers on bf16 operands (``layers``); ``grad_dtype =
bfloat16`` (which needs it) differentiates against a bf16 shadow of the
float32 masters, so the cotangents flow in bf16, and the gradients are
cast back before the update (``update_period > 1`` accumulates them in
float32); ``momentum_dtype = bfloat16`` stores the sgd/nag momentum in
bf16 (``updater``). Snapshots store such buffers as float32, and a
resuming run casts them to its own ``momentum_dtype``.

The freeze is the reference's device-resident serve weight tree
(``serve_weight_residency = 1``, the default): the BN fold vectors are
computed once at load, never per dispatch, and each conv weight is
converted once to PyTorch's OIHW channels-last layout. Under
``conv_pallas_epilogue = 1`` the weight stays raw and the fold
(scale, and the shift with any conv bias folded in) goes to the
conv_epilogue kernel; otherwise the scale multiplies the weight.

``serve_dtype`` (``nnet/quantize.py``): under ``int8`` the fold
multiplies the weight, which is then quantized once into the int8
layout the product reads, and the epilogue gets the per-channel dequant
with the folded shift; under ``bfloat16`` the weights are cast once.
Snapshots carry the calibration tables as ``quant/<layer>/<field>``
arrays and their summary as ``__meta__["quantized"]``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import NetGraph
from ..io.data import DataBatch, batch_mask
from ..layers.conv import hwio_to_oihw
from ..monitor import warn_once
from ..updater import create_updater
from ..utils.config import (ConfigError, ConfigPairs, NotPortedError,
                            Roadmap)
from ..utils.metric import MetricSet
from ..utils.stream import local_path
from .checkpoint import read_snapshot, write_snapshot
from .convert import (OptTree, Tree, opt_from_numpy, params_from_numpy,
                      params_to_numpy)
from .net import FuncNet
from .quantize import (QUANT_PREFIX, attach, normalize_serve_dtype,
                       tables_from_blob)

_RE_METRIC = re.compile(r"^metric(?:\[([^\]]*)\])?$")
_RAW_DTYPES = (torch.uint8, torch.bfloat16)


class FinetuneShapeError(ValueError):
    """A finetune source holds a parameter whose shape no longer matches
    the configured net, and the layer is not listed in
    ``finetune_remap``; ``layer`` and ``tag`` name the group."""

    def __init__(self, layer: str, tag: str, saved_shape, new_shape):
        self.layer = layer
        self.tag = tag
        self.saved_shape = tuple(saved_shape)
        self.new_shape = tuple(new_shape)
        super().__init__(
            "finetune: layer %r param %r changed shape %s -> %s but is "
            "not listed in finetune_remap — declare it "
            "(finetune_remap = %s) for a fresh re-init, or fix the net "
            "config (finetune_strict = 0 restores the silent "
            "skip-and-reinit behavior)"
            % (layer, tag, tuple(saved_shape), tuple(new_shape), layer))


@dataclass
class DeviceBatch(DataBatch):
    """A batch whose ``data``, ``label`` and ``extra_data`` are tensors
    on the trainer's device (``NetTrainer.device_put_batch``).
    ``host_label`` is a private host copy of the labels (the train and
    eval metrics read them on the host), ``mask`` the padded-row mask on
    the device (None when every row is real) and ``ready`` the CUDA
    event recorded after the copies on the trainer's copy stream (None
    on the CPU)."""
    host_label: Optional[np.ndarray] = None
    mask: Optional[torch.Tensor] = None
    ready: Any = None


def _host_tensor(a) -> torch.Tensor:
    """Rows as a tensor of the dtype they ship in: uint8 pixels and
    bf16 rows raw (the net normalizes them), everything else float32.
    Aliases ``a`` where no cast or compaction is needed."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a if a.dtype in _RAW_DTYPES else a.float()


class NetTrainer:
    """A net, its weights and optimizer state on one device, for
    training and evaluation.

    ``device`` defaults to the GPU; without one it raises unless the
    caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: ConfigPairs = (), device=None):
        self.cfg: List[Tuple[str, str]] = list(cfg)
        self.device = resolve_device(device)
        self.batch_size = 0
        self.seed = 0
        self.update_period = 1
        self.eval_train = 1
        self.save_optimizer = 0
        self.grad_dtype = "float32"      # bfloat16: bf16 cotangents
        self.serve_dtype = "float32"     # eval/pred compute dtype:
        #                                  float32 | bfloat16 | int8;
        #                                  int8 needs calibration tables
        self.quant_tables: Dict[str, Dict[str, np.ndarray]] = {}
        self.quant_meta: Dict[str, Any] = {}   # __meta__["quantized"]
        self.quant_report: Dict[str, Any] = {"active": False}
        self.serve_weight_residency = 1
        self.silent = 0
        # precompile(): the input dtype of its zero batch (uint8 for
        # raw-pixel pipelines)
        self.precompile_dtype = "float32"
        self.metric_cfg: List[Tuple[str, str, str]] = []
        self.sample_counter = 0          # within accumulation window
        self.update_counter = 0          # applied updates (schedule epoch)
        self.opt_state: OptTree = {}
        # update_period > 1: f32 gradient sums of the open window, by
        # (layer, tag)
        self.grad_acc: Optional[Dict[Tuple[str, str], torch.Tensor]] = None
        self._last_loss: Optional[torch.Tensor] = None
        self._serve_tree: Optional[Tree] = None
        self._initialized = False
        # progress counters (the CLI's round lines and
        # counters_snapshot): update calls (an update_many window counts
        # once), real (non-padded) rows, and the open round's window
        self.round = 0
        self._steps_total = 0
        self._examples_total = 0
        self._round_examples = 0
        self._round_t0: Optional[float] = None   # set by start_round
        self.last_round_examples_per_sec = 0.0   # of the closed round
        self.last_round_examples = 0
        self.last_round_wall_s = 0.0
        # device_put_batch: its copy stream (made at first use) and
        # counts of the batches it staged and of those whose data it
        # read straight from pinned memory
        self._copy_stream = None
        self._stream_lock = threading.Lock()
        self.staging = {"batches": 0, "pinned": 0}
        # telemetry (set_monitor): the monitor, the iterator wait the
        # drive loop reported since the last dispatch, and the dispatch
        # signatures seen (a first sighting paid first-use costs)
        self._mon = None
        self._pending_data_wait = 0.0
        self._seen_sigs: set = set()
        self.input_layout = "none"

    # -- config ----------------------------------------------------------

    def set_param(self, name: str, val: str) -> None:
        self.cfg.append((name, val))

    def _absorb_globals(self) -> None:
        self.metric_cfg = []             # (metric, label field, node)
        for name, val in self.cfg:
            if name == "batch_size":
                self.batch_size = int(val)
            if name == "update_period":
                self.update_period = int(val)
            if name in ("eval_train", "train_eval"):
                self.eval_train = int(val)
            if name == "save_optimizer":
                self.save_optimizer = int(val)
            if name == "seed":
                self.seed = int(val)
            if name == "grad_dtype":
                if val not in ("float32", "bfloat16"):
                    raise ValueError(
                        "grad_dtype must be float32 or bfloat16")
                self.grad_dtype = val
            if name == "remat":
                if val not in ("none", "0", "full", "dots", "conv"):
                    raise ValueError("remat must be none|full|dots|conv")
                if val not in ("none", "0"):
                    raise NotPortedError("remat = %s" % val, Roadmap.REMAT)
            if name == "grad_sync":
                if val not in ("fused", "overlap"):
                    raise ValueError("grad_sync must be fused|overlap")
                if val == "overlap":
                    raise NotPortedError("grad_sync = overlap",
                                         Roadmap.MULTI_GPU)
            if name in ("shard_optimizer", "update_on_server",
                        "optim_shard") and int(val):
                raise NotPortedError("%s = %s" % (name, val),
                                     Roadmap.MULTI_GPU)
            m = _RE_METRIC.match(name)
            if m:
                field, node = "label", ""
                if m.group(1):
                    parts = [p.strip() for p in m.group(1).split(",")]
                    field = parts[0] or "label"
                    if len(parts) > 1:
                        node = parts[1]
                self.metric_cfg.append((val, field, node))
            if name == "serve_dtype":
                self.serve_dtype = normalize_serve_dtype(val)
            if name == "serve_weight_residency":
                self.serve_weight_residency = int(val)
            if name == "serve_device_mem_budget" and float(val):
                raise NotPortedError("serve_device_mem_budget",
                                     Roadmap.QUANTIZED)
            if name == "silent":
                self.silent = int(val)
            if name == "precompile_dtype":
                if val not in ("float32", "uint8"):
                    raise ValueError(
                        "precompile_dtype must be float32 or uint8")
                self.precompile_dtype = val
            if name == "input_layout":
                if val not in ("none", "rowmajor"):
                    raise ValueError(
                        "input_layout must be none or rowmajor")
                self.input_layout = val
                if val == "rowmajor":
                    # a TPU device-layout pin; CUDA tensors of the port
                    # are row-major (NHWC) already, so the batch runs
                    # as it is, as the reference does where its backend
                    # cannot pin
                    warn_once("input_layout_unsupported",
                              "input_layout=rowmajor pins a TPU device "
                              "layout; the CUDA batch is already "
                              "row-major (NHWC), inputs stay unpinned")

    # -- model lifecycle -------------------------------------------------

    def _build_net(self) -> None:
        if self.batch_size == 0:
            self.batch_size = self.graph.batch_size
        if self.batch_size <= 0:
            raise ConfigError("batch_size must be set")
        self.net = FuncNet(self.graph, self.batch_size)

    def init_model(self) -> None:
        """A fresh model: weights drawn from ``seed``."""
        self._absorb_globals()
        self.graph = NetGraph()
        self.graph.configure(self.cfg)
        self._build_net()
        params, state = self.net.init(self.seed)
        self._install(params, state)
        self._post_init()

    def load_model(self, path: str) -> None:
        """Load a snapshot (either package's), digest verified; its
        optimizer state, when it carries one, resumes too."""
        if os.path.isdir(local_path(path)):
            raise NotPortedError("a bundle as model_path (%r)" % path,
                                 Roadmap.BUNDLES)
        blob, meta = read_snapshot(path)
        self._absorb_globals()
        self.graph = NetGraph.from_dict(meta["structure"])
        self.graph.configure(self.cfg)
        self._build_net()
        params, state = self.net.init(self.seed)
        saved_p, saved_s = params_from_numpy(blob, "cpu")
        for tree, saved in ((params, saved_p), (state, saved_s)):
            for lk, sub in tree.items():
                for tag in sub:
                    if tag in saved.get(lk, {}):
                        sub[tag] = saved[lk][tag]
        self.update_counter = int(meta.get("update_counter", 0))
        # calibration ranges load before _post_init, where the
        # serve_dtype activation reads them
        self.quant_tables = tables_from_blob(blob)
        self.quant_meta = dict(meta.get("quantized", {}))
        self._install(params, state)
        self._post_init()
        saved_o = opt_from_numpy(blob, self.device)
        for lk, tags in self.opt_state.items():
            for tag, st in tags.items():
                for k in st:
                    if k in saved_o.get(lk, {}).get(tag, {}):
                        # snapshots store float32; the momentum_dtype of
                        # the resuming run wins
                        st[k] = saved_o[lk][tag][k].to(st[k].dtype)

    def _post_init(self) -> None:
        """What init_model and load_model share after the weights are
        in place: one updater per (layer, tag) and its state, the metric
        bindings and the label fields."""
        g = self.graph
        if self.grad_dtype == "bfloat16" and not any(
                k == "dtype" and v == "bfloat16" for k, v in self.cfg):
            raise ValueError(
                "grad_dtype=bfloat16 requires dtype=bfloat16 (layers "
                "must consume the bf16 weight shadow)")
        self.updaters: Dict[str, Dict[str, Any]] = {}
        for lkey, ptree in self.params.items():
            li = g.layer_name_map[lkey] if lkey in g.layer_name_map \
                else int(lkey[5:])
            self.updaters[lkey] = {
                tag: create_updater(g.updater_type, tag, g.defcfg,
                                    g.layercfg[li])
                for tag in ptree}
        self.opt_state = {
            lk: {tag: self.updaters[lk][tag].init_state(w)
                 for tag, w in pt.items()}
            for lk, pt in self.params.items()}
        self.grad_acc = None
        self._metrics = MetricSet()
        self._train_metrics = MetricSet()
        self._metric_nodes: List[int] = []
        top = g.num_nodes - 1
        for mname, field, node in self.metric_cfg:
            self._metrics.add_metric(mname, field, node)
            self._train_metrics.add_metric(mname, field, node)
            self._metric_nodes.append(
                self.net.node_index_by_name(node) if node else top)
        self._label_slices = g.label_slices()
        self._attach_quant()
        self._emit_model_records()

    def _attach_quant(self) -> None:
        """Pin the ``serve_dtype`` specs on the layers (raises for int8
        without calibration tables); the frozen serve tree is rebuilt."""
        self.quant_report = attach(self)
        self._serve_tree = None

    def set_quantization(self, tables, meta,
                         dtype: Optional[str] = None) -> None:
        """Install calibration range tables (and optionally switch the
        serve dtype): the next eval forward runs the quantized graph, and
        every later snapshot carries the tables as ``quant/`` arrays."""
        self._check_ready()
        self.quant_tables = dict(tables)
        self.quant_meta = dict(meta)
        if dtype is not None:
            self.serve_dtype = normalize_serve_dtype(dtype)
        self._attach_quant()
        self._emit_model_records()

    def _install(self, params: Tree, state: Tree) -> None:
        dev = self.device
        self.params = {lk: {t: v.to(dev) for t, v in sub.items()}
                       for lk, sub in params.items()}
        self.net_state = {lk: {t: v.to(dev) for t, v in sub.items()}
                          for lk, sub in state.items()}
        self._serve_tree = None
        self._initialized = True

    # -- frozen serve weights --------------------------------------------

    def freeze_serve_weights(self) -> Optional[Tree]:
        """Build (once) the eval weight tree every pred forward reads:
        per conv the BN fold and the weight in the layout its
        contraction reads, per fullc its int8 or bf16 weight (see the
        module docstring). None when ``serve_weight_residency = 0``: the
        forward then folds, quantizes and converts per call, as the
        reference's legacy path does."""
        self._check_ready()
        if not self.serve_weight_residency:
            return None
        if self._serve_tree is not None:
            return self._serve_tree
        net, g = self.net, self.graph
        shared_primaries = set(info.primary_layer_index
                               for info in g.layers
                               if info.type == "share")
        tree = {lk: dict(sub) for lk, sub in self.params.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            for li, info in enumerate(g.layers):
                if info.type not in ("conv", "fullc"):
                    continue
                lkey = g.layer_key(li)
                p, t = self.params[lkey], tree[lkey]
                layer = net.layer_objs[li]
                if getattr(layer, "_in_layout", None) is not None \
                        or getattr(layer, "_out_pad", 0):
                    # channel_pad layers keep the per-call path (a
                    # training knob; serving graphs run unpadded)
                    continue
                q = layer._quant
                quant = q is not None and q.is_affine
                bf16 = layer.param.compute_dtype == "bfloat16" or (
                    q is not None and q.dtype == "bfloat16")
                w = p["wmat"]
                if li in shared_primaries:
                    # every share site runs this layer's object: its
                    # fold and quantization stay per call (the
                    # reference's resident plan skips it); the conv
                    # weight's layout (and bf16 cast) is frozen
                    if info.type == "conv" and not quant:
                        w = hwio_to_oihw(w)
                        t["_oihw"] = w.to(torch.bfloat16) if bf16 else w
                    continue
                if info.type == "fullc":
                    if quant:
                        t["_wq"] = q.weight_operand(w)
                        t["_r_dequant"] = q.dequant_vec()
                    elif bf16:
                        t["wmat"] = w.to(torch.bfloat16)
                    continue
                bias = p["bias"] if layer.param.no_bias == 0 else None
                shift, relu = bias, False
                if net.bn_fold_eval and li in net.fold_pairs:
                    fe = net.fold_entries(self.params, self.net_state, li)
                    scale, shift = fe["_fold_scale"], fe["_fold_shift"]
                    if bias is not None:
                        shift = shift + bias * scale
                    relu = "_fold_relu" in fe
                    if layer.param.conv_pallas_epilogue and not quant:
                        # the fold applies to the conv output
                        t["_ep_scale"] = scale.contiguous()
                        t["_ep_shift"] = shift.contiguous()
                        if relu:
                            t["_ep_relu"] = fe["_fold_relu"]
                    else:
                        # the fold multiplies the weight (before it is
                        # quantized); the shift goes after the conv
                        w = w * scale
                        t["_r_shift_relu" if relu else "_r_shift"] = shift
                if quant:
                    dq = q.dequant_vec()
                    t["_wq"] = q.weight_operand(w)
                    t["_r_dequant"] = dq
                    if "_r_shift" not in t and "_r_shift_relu" not in t:
                        t["_r_shift"] = shift if shift is not None \
                            else torch.zeros_like(dq)
                else:
                    w = hwio_to_oihw(w)
                    t["_oihw"] = w.to(torch.bfloat16) if bf16 else w
        self._serve_tree = tree
        if self._mon_on():
            self._emit_residency(tree, time.perf_counter() - t0)
        return tree

    def _emit_residency(self, tree: Tree, wall: float) -> None:
        """The ``weight_residency`` record of a freeze: the tree's bytes,
        the masters' (params and net state) and their union, each
        storage counted once (a leaf the freeze left as it was aliases
        its master); ``layers`` counts the conv and fullc layers whose
        eval weights the freeze transformed (fold, quantization, bf16
        cast or the OIHW layout)."""
        def nbytes(trees, seen):
            tot = 0
            for tr in trees:
                for sub in tr.values():
                    for v in sub.values():
                        st = v.untyped_storage()
                        key = (st.device, st.data_ptr())
                        if key not in seen:
                            seen.add(key)
                            tot += st.nbytes()
            return tot
        seen: set = set()
        master = nbytes((self.params, self.net_state), seen)
        total = master + nbytes((tree,), seen)
        layers = sum(
            1 for lk, sub in tree.items()
            if any(sub[t] is not self.params[lk].get(t) for t in sub))
        self._mon.emit(
            "weight_residency", bytes=total,
            tree_bytes=nbytes((tree,), set()), master_bytes=master,
            quantize_ms=wall * 1e3, layers=layers,
            dtype=self.serve_dtype, active=bool(layers))

    def _pred_operands(self) -> Tree:
        tree = self.freeze_serve_weights()
        return self.params if tree is None else tree

    def pred(self, data: torch.Tensor, nodes_wanted: Sequence[int],
             mask=None, extra: Sequence[torch.Tensor] = ()
             ) -> List[torch.Tensor]:
        """Eval forward of a device batch; float32 values of the wanted
        nodes, on the device. ``mask`` (``batch_mask``, host or device)
        keeps a padded tail out of the batch moments that
        ``batch_norm_no_ma`` normalizes with at eval; ``extra`` holds
        the extra input nodes' values."""
        params = self._pred_operands()
        if mask is not None:
            mask = torch.as_tensor(mask).to(data.device)
        with torch.inference_mode():
            nodes, _, _ = self.net.forward(params, self.net_state, data,
                                           mask=mask, extra=extra)
            return [self.net.depad_node(i, nodes[i]).float()
                    for i in nodes_wanted]

    def to_device_batch(self, x) -> torch.Tensor:
        """Rows -> a tensor on the device: uint8 pixels and bf16 rows
        ship raw (the net normalizes them), everything else as float32;
        a tensor already there is taken as it is."""
        return _host_tensor(x).to(self.device)

    def device_put_batch(self, batch: DataBatch) -> DeviceBatch:
        """Stage a host batch on the device: the transform the CLI hands
        ``PrefetchIterator.set_transform``, so the copy runs in the
        prefetch thread, overlapped with compute.

        On CUDA, ``data``, ``label``, the mask and each ``extra_data``
        are copied with ``non_blocking=True`` on the trainer's own copy
        stream, from pinned memory: straight from a pinned ring buffer,
        else through a pinned copy (PyTorch's caching host allocator
        keeps that alive until its copy is done). The returned batch's
        ``ready`` event follows the copies; the consumer's stream waits
        on it (``_await``). The host arrays may be reused once ``ready``
        has completed. On the CPU the tensors are private copies."""
        host_label = None if batch.label is None \
            else np.array(batch.label, np.float32)
        rows = [batch.data, batch.label, batch_mask(batch)] \
            + list(batch.extra_data)
        rows = [None if a is None else _host_tensor(a) for a in rows]
        ready = None
        if self.device.type == "cuda":
            with self._stream_lock:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
            pinned = rows[0].is_pinned()
            out = []
            with torch.cuda.stream(self._copy_stream):
                for t in rows:
                    if t is not None and not t.is_pinned():
                        t = t.pin_memory()
                    out.append(None if t is None else
                               t.to(self.device, non_blocking=True))
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        else:
            pinned = False
            out = [None if t is None else t.clone() for t in rows]
        self.staging["batches"] += 1
        self.staging["pinned"] += int(pinned)
        return DeviceBatch(
            data=out[0], label=out[1],
            # copies: the source may be a ring buffer handed back for
            # refill while this batch waits in the queue
            inst_index=None if batch.inst_index is None
            else np.array(batch.inst_index),
            num_batch_padd=batch.num_batch_padd, extra_data=out[3:],
            host_label=host_label, mask=out[2], ready=ready)

    def _await(self, batch: DeviceBatch) -> None:
        """Order the current stream after a staged batch's copies, and
        keep the allocator from handing their memory to the copy stream
        before the current stream's work on them is done."""
        if batch.ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(batch.ready)
        for t in [batch.data, batch.label, batch.mask] \
                + list(batch.extra_data):
            if t is not None and t.device.type == "cuda":
                t.record_stream(cur)

    def _inputs(self, batch: DataBatch):
        """(data, mask, extra) of a batch on the device; a staged batch
        (``DeviceBatch``) is taken as it is, after its copies."""
        if isinstance(batch, DeviceBatch):
            self._await(batch)
            mask = batch.mask
        else:
            mask = batch_mask(batch)
            mask = None if mask is None \
                else torch.from_numpy(mask).to(self.device)
        return (self.to_device_batch(batch.data), mask,
                tuple(self.to_device_batch(e) for e in batch.extra_data))

    @staticmethod
    def _host_label(batch: DataBatch) -> np.ndarray:
        """The labels as float32 numpy, for the metrics."""
        host = getattr(batch, "host_label", None)
        if host is not None:
            return host
        if isinstance(batch.label, torch.Tensor):
            return batch.label.float().cpu().numpy()
        return np.asarray(batch.label, np.float32)

    @staticmethod
    def rows_to_prediction(m: np.ndarray) -> np.ndarray:
        """Output rows -> per-row prediction: the single raw column, or
        the argmax class as float32."""
        m = m.reshape(m.shape[0], -1)
        if m.shape[1] == 1:
            return m[:, 0]
        return np.argmax(m, axis=1).astype(np.float32)

    def predict(self, batch: DataBatch) -> np.ndarray:
        """argmax class (or raw scalar) per row of the top node."""
        top = self.graph.num_nodes - 1
        data, mask, extra = self._inputs(batch)
        (val,) = self.pred(data, (top,), mask, extra)
        nvalid = batch.batch_size - batch.num_batch_padd
        out = val[:nvalid].cpu().numpy()
        return self.rows_to_prediction(out)

    def extract_feature(self, batch: DataBatch, node: str) -> np.ndarray:
        """The node's value for the valid rows, in its natural shape."""
        ni = self.net.node_index_by_name(node)
        data, mask, extra = self._inputs(batch)
        (val,) = self.pred(data, (ni,), mask, extra)
        nvalid = batch.batch_size - batch.num_batch_padd
        return val[:nvalid].cpu().numpy()

    # -- training --------------------------------------------------------

    def _device_batch(self, batch: DataBatch):
        """(data, labels, mask, extra) of a batch on the device; the mask
        is None when every row is real."""
        if batch.label is None:
            raise ValueError("a training batch needs labels")
        data, mask, extra = self._inputs(batch)
        labels = _host_tensor(batch.label).float().to(self.device)
        return data, labels, mask, extra

    def _label_fields(self, label: np.ndarray, nvalid: int):
        return {name: label[:nvalid, a:b]
                for name, a, b in self._label_slices}

    def _apply_updates(self, grads: Dict[Tuple[str, str], torch.Tensor],
                       epoch: int) -> None:
        """One update of every trained (layer, tag) from its gradient,
        with its schedule at ``epoch``; frozen groups (no optimizer
        state) pass through untouched. lr, momentum and wd enter as
        float32 values, as the reference's packed hyper array holds
        them; the epoch as an exact int."""
        params = {lk: dict(sub) for lk, sub in self.params.items()}
        for (lk, tag), g in grads.items():
            if self.update_period > 1:
                g = g / float(self.update_period)
            upd = self.updaters[lk][tag]
            upd.param.schedule_epoch(epoch)
            hy = {"learning_rate": float(np.float32(upd.param.learning_rate)),
                  "momentum": float(np.float32(upd.param.momentum)),
                  "wd": float(np.float32(upd.param.wd)), "epoch": int(epoch)}
            params[lk][tag], self.opt_state[lk][tag] = \
                upd.apply(self.params[lk][tag], g, self.opt_state[lk][tag], hy)
        self.params = params

    def _step_scalar(self) -> int:
        """The global sample step the next batch's randomness is drawn
        for: ``update_counter * update_period + sample_counter``, as a
        uint32, as the reference's ``NetTrainer._step_scalar``."""
        return (self.update_counter * self.update_period
                + self.sample_counter) & 0xFFFFFFFF

    def _train_step(self, data: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor], epoch: int,
                    do_update: bool, collect: bool, step: int,
                    extra: Sequence[torch.Tensor] = ()
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The reference's ``scan_step``: loss and gradients of one
        batch, then the update (or, under ``update_period > 1``, the f32
        accumulation that a closing window applies). ``step`` is the
        global sample step the layers' randomness is drawn for; ``extra``
        the extra input nodes' values. Returns the loss and, with
        ``collect``, the metric nodes' values.

        Under ``grad_dtype = bfloat16`` the forward reads a bf16 shadow
        of every float32 weight, so autograd hands back bf16 gradients;
        they are cast to the masters' dtype before the update."""
        trained = [(lk, tag) for lk, tags in self.opt_state.items()
                   for tag, st in tags.items() if st]
        shadow = self.grad_dtype == "bfloat16"
        leaves = {lk: {t: v.to(torch.bfloat16)
                       if shadow and v.dtype == torch.float32 else v
                       for t, v in sub.items()}
                  for lk, sub in self.params.items()}
        for lk, tag in trained:
            leaves[lk][tag] = leaves[lk][tag].detach().requires_grad_(True)
        nodes = tuple(self._metric_nodes) if collect else ()
        with torch.enable_grad():
            loss, (new_state, preds) = self.net.loss_fn(
                leaves, self.net_state, data, labels, mask, nodes,
                rng=(self.seed, step), extra=extra)
            grads = torch.autograd.grad(
                loss, [leaves[lk][tag] for lk, tag in trained]) \
                if trained else ()
        preds = [p.detach().float() for p in preds]
        self.net_state = new_state
        self._serve_tree = None          # weights move: the frozen
        #                                  serve tree is stale
        with torch.no_grad():
            g = {k: v.to(self.params[k[0]][k[1]].dtype)
                 for k, v in zip(trained, grads)}
            if self.update_period == 1:
                self._apply_updates(g, epoch)
            else:
                if self.grad_acc is None:
                    self.grad_acc = {k: torch.zeros_like(v)
                                     for k, v in g.items()}
                for k, v in g.items():
                    self.grad_acc[k] = self.grad_acc[k] + v.float()
                if do_update:
                    self._apply_updates(self.grad_acc, epoch)
                    self.grad_acc = None
        return loss.detach(), preds

    def _check_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("call init_model/load_model first")

    def start_round(self, r: int) -> None:
        """Open round ``r``'s counter window (closing the previous one)."""
        self.end_round()
        self.round = r
        self._round_t0 = time.perf_counter()
        self._round_examples = 0

    def end_round(self) -> None:
        """Close the current round's counter window (idempotent): sets
        the ``last_round_*`` fields."""
        if self._round_t0 is None:
            return
        dt = time.perf_counter() - self._round_t0
        if dt > 0:
            self.last_round_examples_per_sec = self._round_examples / dt
        self.last_round_examples = self._round_examples
        self.last_round_wall_s = dt
        self._round_t0 = None

    def counters_snapshot(self) -> Dict[str, float]:
        """Progress so far, without a device sync: update dispatches,
        real examples consumed, and the throughput of the last closed
        round."""
        return {"steps": self._steps_total,
                "examples": self._examples_total,
                "last_round_examples_per_sec":
                    self.last_round_examples_per_sec}

    def _count_examples(self, examples: int) -> None:
        self._steps_total += 1
        self._examples_total += examples
        self._round_examples += examples

    # -- telemetry -------------------------------------------------------

    def set_monitor(self, mon) -> None:
        """Attach a ``monitor.Monitor`` (None detaches). With an enabled
        sink every dispatch (``update``, ``update_many``, ``run_steps``)
        emits a ``step`` record whose ``wall_ms`` runs to a device sync:
        an honest step time, at the cost of the overlap of the host's
        next dispatch with this one's device work. A disabled monitor
        leaves the update path as it is: no sync, no clock read."""
        self._mon = mon
        if self._initialized:
            self._emit_model_records()

    def _mon_on(self) -> bool:
        return self._mon is not None and self._mon.enabled

    def _emit_model_records(self) -> None:
        """The static records of a built model: ``model_info`` (the
        analytic FLOPs an example, the MFU denominator), ``layout`` (the
        fusion and padding passes' decisions) and, under a
        ``serve_dtype``, ``quantized_model``."""
        if not self._mon_on():
            return
        net = self.net
        fwd = net.analytic_flops_per_example()
        self._mon.emit(
            "model_info", flops_per_example=fwd,
            train_flops_per_example=3.0 * fwd,
            params=sum(int(w.numel()) for pt in self.params.values()
                       for w in pt.values()),
            layers=len(self.graph.layers))
        self._mon.emit(
            "layout", input_layout=self.input_layout,
            bn_fuse_relu=len(net._identity_layers),
            bn_fold_eval_pairs=len(net.fold_pairs),
            pool_concat_fused=len(net.fused_concats),
            **net.layout_summary)
        r = self.quant_report
        if r.get("active"):
            self._mon.emit("quantized_model", dtype=r["dtype"],
                           layers=r["layers"],
                           fallback_layers=r["fallback_layers"],
                           native=r["native"])

    def note_data_wait(self, seconds: float) -> None:
        """The drive loop reports the time it waited on the iterator
        since the last dispatch; the next ``step`` record carries it as
        ``data_wait_ms``."""
        self._pending_data_wait += seconds

    def _sig(self, kind: str, batches: Sequence[DataBatch], n: int = 0
             ) -> tuple:
        """The reference's dispatch signature of ``kind`` over
        ``batches`` (``cxxnet_tpu/artifact/registry.py``'s
        ``update_sig``, ``update_many_sig``, ``run_steps_sig``), with
        ``n`` its apply flag, window or step count."""
        b = batches[0]
        data = tuple(b.data.shape)
        dt = str(b.data.dtype).replace("torch.", "")
        label = tuple(b.label.shape) if b.label.ndim == 2 \
            else (b.label.shape[0], 1)
        no_mask = all(x.num_batch_padd == 0 for x in batches)
        n_extra = len(b.extra_data)
        if kind == "update_many":
            k = len(batches)
            return ((k,) + data, dt, (k,) + label, no_mask, n_extra, k,
                    bool(n))
        return (data, dt, label, no_mask, n_extra,
                bool(n) if kind == "update" else int(n))

    def _note_signature(self, kind: str, sig: tuple, wall: float) -> bool:
        """The first sighting of a dispatch signature: its wall time paid
        first-use costs. On the card those are cuDNN's algorithm search
        for the new shapes, the allocator's growth and, on a net's first
        dispatch, the build of its kernels (``nvcc``, unless
        ``precompile`` ran). Emits a ``compile`` record ("first" or
        "recompile") and returns True when so."""
        key = (kind,) + sig
        if key in self._seen_sigs:
            return False
        first = not self._seen_sigs
        self._seen_sigs.add(key)
        self._mon.emit("compile", kind="first" if first else "recompile",
                       wall_ms=wall * 1e3, signature=repr(key))
        return True

    def _emit_step(self, kind: str, batches: Sequence[DataBatch],
                   n: int, examples: int, t0: float, counter: int,
                   epoch: int) -> None:
        """The ``step`` record of a dispatch that began at ``t0`` (host
        clock), after a device sync; ``counter`` is the update counter
        before it, ``epoch`` its first batch's schedule epoch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        compiled = self._note_signature(kind, self._sig(kind, batches, n),
                                        wall)
        wait, self._pending_data_wait = self._pending_data_wait, 0.0
        n_batches = len(batches) if kind == "update_many" \
            else (n if kind == "run_steps" else 1)
        self._mon.emit(
            "step", step=self._steps_total, round=self.round,
            dispatch=kind, n_batches=n_batches, examples=examples,
            wall_ms=wall * 1e3, data_wait_ms=wait * 1e3,
            examples_per_sec=examples / wall if wall > 0 else 0.0,
            update_counter=counter, lr=self._lr_at(epoch),
            compile=compiled)

    def _lr_at(self, epoch: int) -> float:
        """The learning rate of the first (layer, tag) in sorted order
        at ``epoch``, as float32: the reference's ``hyper[0, 0]``."""
        if not self.updaters:
            return 0.0
        lk = sorted(self.updaters)[0]
        upd = self.updaters[lk][sorted(self.updaters[lk])[0]]
        upd.param.schedule_epoch(epoch)
        return float(np.float32(upd.param.learning_rate))

    # -- updates ---------------------------------------------------------

    def update(self, batch: DataBatch) -> None:
        """One training step on a host or staged batch (its padded tail
        excluded from the BN moments and the loss)."""
        mon = self._mon_on()
        t0 = time.perf_counter() if mon else 0.0
        counter, sample = self.update_counter, self.sample_counter
        self._update(batch)
        ex = batch.batch_size - batch.num_batch_padd
        self._count_examples(ex)
        if mon:
            self._emit_step("update", [batch],
                            sample + 1 >= self.update_period, ex, t0,
                            counter, counter)

    def _update(self, batch: DataBatch) -> None:
        self._check_ready()
        data, labels, mask, extra = self._device_batch(batch)
        epoch = self.update_counter
        step = self._step_scalar()
        self.sample_counter += 1
        do_update = self.sample_counter >= self.update_period
        collect = bool(self.eval_train and self._metrics.evals)
        self._last_loss, preds = self._train_step(
            data, labels, mask, epoch, do_update, collect, step, extra)
        if do_update:
            self.sample_counter = 0
            self.update_counter += 1
        if collect:
            nvalid = batch.batch_size - batch.num_batch_padd
            self._train_metrics.add_eval(
                [p[:nvalid].cpu().numpy() for p in preds],
                self._label_fields(self._host_label(batch), nvalid))

    def run_steps(self, batch: DataBatch, n_steps: int) -> None:
        """``n_steps`` training steps on one resident batch, with the
        schedule and the step's randomness advancing per step and
        ``update_period`` windows closing as in ``update``."""
        self._check_ready()
        n = int(n_steps)
        if n <= 0:
            return
        mon = self._mon_on()
        t0 = time.perf_counter() if mon else 0.0
        data, labels, mask, extra = self._device_batch(batch)
        period = self.update_period
        S, U = self.sample_counter, self.update_counter
        step0 = self._step_scalar()
        for i in range(n):
            epoch = U + (S + i) // period
            self._last_loss, _ = self._train_step(
                data, labels, mask, epoch, ((S + i + 1) % period) == 0,
                False, (step0 + i) & 0xFFFFFFFF, extra)
        ex = (batch.batch_size - batch.num_batch_padd) * n
        self._count_examples(ex)
        if mon:
            self._emit_step("run_steps", [batch], n, ex, t0, U, U)
        self.update_counter = U + (S + n) // period
        self.sample_counter = (S + n) % period

    def update_many(self, batches: Sequence[DataBatch]) -> None:
        """Train on K batches; the same as K ``update`` calls (the
        reference fuses them into one dispatch, which eager PyTorch has
        no use for), counted as one dispatch. Staged batches stay on the
        device."""
        if len(batches) == 1:
            return self.update(batches[0])
        mon = self._mon_on()
        t0 = time.perf_counter() if mon else 0.0
        counter = self.update_counter
        collect = bool(self.eval_train and self._metrics.evals)
        for b in batches:
            self._update(b)
        ex = sum(b.batch_size - b.num_batch_padd for b in batches)
        self._count_examples(ex)
        if mon:
            self._emit_step("update_many", batches, collect, ex, t0,
                            counter, counter)

    @property
    def last_loss(self) -> float:
        """The loss of the last training step (waits for the device)."""
        if self._last_loss is None:
            raise RuntimeError("no training step has run")
        return float(self._last_loss)

    def train_metric_str(self, name: str = "train") -> str:
        """The train metrics accumulated by ``update`` under
        ``eval_train = 1``, as an eval line; clears them."""
        res = self._train_metrics.results()
        self._train_metrics.clear()
        if self._mon_on() and res:
            self._mon.emit("eval", round=self.round, name=name,
                           metrics={t: float(v) for t, v in res})
        return MetricSet.format_line(name, res)

    def evaluate(self, data_iter: Iterable[DataBatch], name: str) -> str:
        """One eval pass; returns ``'\\t<name>-<metric>:<value>'``."""
        return self.evaluate_metrics(data_iter, name)[0]

    def evaluate_metrics(self, data_iter: Iterable[DataBatch], name: str
                         ) -> Tuple[str, Dict[str, float]]:
        """One eval pass over ``DataBatch`` es: the eval line and the
        ``{tag: value}`` dict."""
        if not self._metrics.evals:
            return "", {}
        self._metrics.clear()
        for batch in data_iter:
            data, mask, extra = self._inputs(batch)
            vals = self.pred(data, self._metric_nodes, mask, extra)
            nvalid = batch.batch_size - batch.num_batch_padd
            self._metrics.add_eval(
                [v[:nvalid].cpu().numpy() for v in vals],
                self._label_fields(self._host_label(batch), nvalid))
        res = self._metrics.results()
        vals = {t: float(v) for t, v in res}
        if self._mon_on() and res:
            self._mon.emit("eval", round=self.round, name=name,
                           metrics=vals)
        return MetricSet.format_line(name, res), vals

    # -- weights ---------------------------------------------------------

    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        """Weight in reference convention: fullc (out, in); conv
        (out_ch, in_pg*kh*kw); vectors 1-D."""
        w = self.params[layer_name][tag].detach().cpu().numpy()
        return self._to_ref_layout(w)

    def set_weight(self, layer_name: str, tag: str,
                   value: np.ndarray) -> None:
        cur = self.params[layer_name][tag]
        new = self._from_ref_layout(np.asarray(value, np.float32),
                                    tuple(cur.shape))
        self.params[layer_name] = dict(self.params[layer_name])
        self.params[layer_name][tag] = torch.from_numpy(new).to(self.device)
        self._serve_tree = None          # the frozen tree is stale

    @staticmethod
    def _to_ref_layout(w: np.ndarray) -> np.ndarray:
        if w.ndim == 2:                      # fullc (in,out) -> (out,in)
            return w.T.copy()
        if w.ndim == 4:                      # HWIO -> (out, in*kh*kw)
            kh, kw, ipg, out = w.shape
            return w.transpose(3, 2, 0, 1).reshape(out, ipg * kh * kw)
        return w.copy()

    @staticmethod
    def _from_ref_layout(w: np.ndarray,
                         target_shape: Tuple[int, ...]) -> np.ndarray:
        if len(target_shape) == 2:
            return np.ascontiguousarray(w.T)
        if len(target_shape) == 4:
            kh, kw, ipg, out = target_shape
            return np.ascontiguousarray(
                w.reshape(out, ipg, kh, kw).transpose(2, 3, 1, 0))
        return np.ascontiguousarray(w.reshape(target_shape))

    # -- checkpoint ------------------------------------------------------

    def gather_snapshot(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Everything a snapshot holds, as host arrays, and its meta;
        the optimizer state under ``save_optimizer = 1``. The arrays are
        private copies (``params_to_numpy``): a background writer may
        digest them while later updates run. This is the part of a
        snapshot the training thread pays."""
        arrays = params_to_numpy(
            self.params, self.net_state,
            self.opt_state if self.save_optimizer else None)
        # calibration ranges: quant/<layer>/<field>, digest-covered
        for lkey, tab in self.quant_tables.items():
            for field, v in tab.items():
                arrays["%s%s/%s" % (QUANT_PREFIX, lkey, field)] = \
                    np.array(v)
        meta = {
            "update_counter": self.update_counter,
            "structure": self.graph.to_dict(),
            "cfg": [list(p) for p in self.cfg],
        }
        if self.quant_meta:
            meta["quantized"] = dict(self.quant_meta)
        return arrays, meta

    def save_model(self, path: str) -> None:
        """Verified snapshot, atomically committed; raises on a failed
        write (the CLI's ``CheckpointManager`` warns instead)."""
        arrays, meta = self.gather_snapshot()
        write_snapshot(path, arrays, meta)

    # -- finetune --------------------------------------------------------

    def finetune_from(self, path: str, remap: Sequence[str] = (),
                      strict: bool = True) -> Dict[str, Any]:
        """The ``task = finetune`` bootstrap: carry weights from a
        verified snapshot into this freshly initialized net, by layer
        name with exact shapes; the layers named in ``remap`` keep their
        fresh init and fresh state (a new-label-count head). A layer
        whose saved shape differs and that is not in ``remap`` raises
        :class:`FinetuneShapeError` (``strict=False``: it is skipped and
        keeps its fresh init). Returns the carry accounting."""
        self._check_ready()
        blob, meta = read_snapshot(path)
        remap_set = set(remap)
        unknown = remap_set - set(self.params.keys())
        if unknown:
            raise ValueError(
                "finetune_remap names unknown param layer(s) %s; "
                "known: %s" % (sorted(unknown), sorted(self.params)))
        carried = self._carry_from_blob(blob, remap_set, strict)
        fresh = sorted(remap_set)
        frozen = sorted(set(
            lk for lk, tags in self.updaters.items()
            for tag, upd in tags.items() if upd.param.lr_mult == 0.0))
        rec = {
            "source": path,
            "source_digest": str(meta.get("content_digest", "")),
            "carried": len(carried), "remapped": len(fresh),
            "fresh": sorted(set(self.params) - set(carried) - remap_set),
            "carried_layers": carried, "remapped_layers": fresh,
            "frozen_groups": frozen,
        }
        if self.silent == 0:
            print("finetune_from %s: carried %s; remapped %s%s"
                  % (path, ", ".join(carried) or "<none>",
                     ", ".join(fresh) or "<none>",
                     ("; frozen %s" % ", ".join(frozen)) if frozen
                     else ""))
        if self._mon_on():
            self._mon.emit("finetune", **rec)
        return rec

    def _carry_from_blob(self, blob, remap_set, strict: bool
                         ) -> List[str]:
        """The one name-and-shape carry loop behind ``finetune_from``,
        ``copy_model_from`` and ``load_weights_inplace`` (params and net
        state); returns the carried layer keys."""
        carried = []
        for lk, pt in self.params.items():
            if lk in remap_set:
                continue                 # declared remap: fresh init
            hit = {}
            for tag in pt:
                k = "param/%s/%s" % (lk, tag)
                if k not in blob:
                    continue
                if blob[k].shape != tuple(pt[tag].shape):
                    if strict:
                        raise FinetuneShapeError(
                            lk, tag, blob[k].shape, pt[tag].shape)
                    continue             # skip, keep the fresh init
                hit[tag] = self._blob_tensor(blob[k], pt[tag])
            if hit:
                self.params[lk] = dict(pt, **hit)
                carried.append(lk)
        for lk, st in self.net_state.items():
            if lk in remap_set:
                continue                 # remapped layers keep fresh state
            new = dict(st)
            for kk in st:
                k = "state/%s/%s" % (lk, kk)
                if k in blob and blob[k].shape == tuple(st[kk].shape):
                    new[kk] = self._blob_tensor(blob[k], st[kk])
            self.net_state[lk] = new
        self._serve_tree = None          # the frozen serve tree is stale
        return carried

    def _blob_tensor(self, a: np.ndarray, like: torch.Tensor
                     ) -> torch.Tensor:
        """A snapshot array as a private tensor of ``like``'s dtype on
        the trainer's device."""
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=self.device, dtype=like.dtype)

    def load_weights_inplace(self, path: str) -> None:
        """Refresh params, net state and ``update_counter`` from a
        verified snapshot without rebuilding the net: every array must
        match a live leaf's shape exactly."""
        self._check_ready()
        blob, meta = read_snapshot(path)
        try:
            self._carry_from_blob(blob, set(), strict=True)
        except FinetuneShapeError as e:
            raise ValueError(
                "load_weights_inplace: %s:%s shape %s does not match the "
                "live net's %s — in-place reload requires an identical "
                "structure (use load_model for a structural change)"
                % (e.layer, e.tag, e.saved_shape, e.new_shape)) from None
        self.update_counter = int(meta.get("update_counter",
                                           self.update_counter))

    def copy_model_from(self, path: str) -> None:
        """Copy the weights of the layers whose names match with the
        same shapes, silently skipping the rest (the reference's
        finetune carry). Call after ``init_model``."""
        self._check_ready()
        blob, _ = read_snapshot(path)
        copied = self._carry_from_blob(blob, set(), strict=False)
        if self.silent == 0 and copied:
            print("copy_model_from: copied layers %s" % ", ".join(copied))

    # -- precompile ------------------------------------------------------

    def precompile(self) -> List[str]:
        """Pay the first-use costs before round 0: build (or load) every
        hand kernel the configured net launches, then run one training
        step and one eval forward on a zero batch of the run's static
        shapes (``precompile_dtype``), so cuDNN's algorithm choice and
        the allocator's first growth happen here. Parameters, optimizer
        state, BN statistics, counters, metrics and random generators
        are left exactly as they were: precompile changes when a cost is
        paid, never a result. (The reference's ``window`` picks which
        update_many program to lower; eager PyTorch has none.) The zero
        batch's kernel launches count as any launch does. Under a monitor
        it emits a ``compile`` record (kind "precompile") for the step's
        signature, which it marks seen, and a ``precompile`` record.
        Returns the kernel sources built."""
        self._check_ready()
        from ..io.data import inst_array_shape
        from ..layers import kernels
        t_start = time.perf_counter()
        names = self.net.kernel_sources() \
            if self.device.type == "cuda" else []
        if names:
            kernels.build_kernels(names)
            for n in names:
                kernels._load(n)
        # the step replaces tensors and never writes one in place, but
        # it does assign into the optimizer-state and accumulator dicts:
        # keep copies of those
        saved = (self.params,
                 {lk: dict(tags) for lk, tags in self.opt_state.items()},
                 self.net_state,
                 None if self.grad_acc is None else dict(self.grad_acc),
                 self.sample_counter, self.update_counter,
                 self._last_loss, self._serve_tree, torch.get_rng_state())
        cuda_rng = torch.cuda.get_rng_state(self.device) \
            if self.device.type == "cuda" else None
        g = self.graph
        try:
            data = torch.zeros(
                (self.batch_size,) + inst_array_shape(g.input_shape),
                dtype=torch.uint8 if self.precompile_dtype == "uint8"
                else torch.float32, device=self.device)
            lw = max((b for _, _a, b in self._label_slices), default=1)
            labels = torch.zeros((self.batch_size, lw),
                                 dtype=torch.float32, device=self.device)
            extra = tuple(
                torch.zeros((self.batch_size,) + inst_array_shape(s),
                            device=self.device)
                for s in g.extra_shape[:g.extra_data_num])
            t_step = time.perf_counter()
            self._train_step(data, labels, None, self.update_counter,
                             True, False, self._step_scalar(), extra)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            step_wall = time.perf_counter() - t_step
            (self.params, self.opt_state, self.net_state, self.grad_acc,
             self.sample_counter, self.update_counter, self._last_loss,
             self._serve_tree, _) = saved
            if self._metric_nodes:
                self.pred(data, self._metric_nodes, None, extra)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            (self.params, self.opt_state, self.net_state, self.grad_acc,
             self.sample_counter, self.update_counter, self._last_loss,
             self._serve_tree, rng) = saved
            torch.set_rng_state(rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
        # the first dispatch of the warmed signature is not a first use
        key = ("update",) + self._sig(
            "update", [DataBatch(data=data, label=labels,
                                 extra_data=list(extra))], True)
        self._seen_sigs.add(key)
        if self._mon_on():
            self._mon.emit("compile", kind="precompile",
                           wall_ms=step_wall * 1e3, signature=repr(key))
            self._mon.emit("precompile",
                           wall_ms=(time.perf_counter() - t_start) * 1e3,
                           programs=1 + bool(self._metric_nodes))
        return list(names)
