"""Post-training low-precision inference: calibration, scales, dequant
(the port's own copy of ``cxxnet_tpu/nnet/quantize.py``).

- **calibration** (:class:`Calibrator`): eval batches run through the
  net; per-channel activation amax is recorded at the input of every
  quantizable contraction (conv / fullc), and :meth:`Calibrator.finish`
  adds per-out-channel weight amax over the *eval-folded* weights (the
  ``bn_fold_eval`` fold is part of the served graph).
- **scales in the snapshot**: the ranges ride as ``quant/<layer>/...``
  arrays in the npz, covered by the content digest like every array,
  and the summary in ``__meta__["quantized"]``.
- **activation** (:func:`attach`): ``serve_dtype = int8|bfloat16``
  turns the ranges into symmetric scales (per tensor for activations,
  per out channel for weights) and pins a :class:`QuantSpec` on each
  quantizable layer; the eval forward then quantizes the activation on
  the device, contracts int8 into int32 (``layers/quant_ops.py``) and
  applies the per-channel dequant in the conv_epilogue kernel.

Quantization is bit for bit the reference's: a division by the float32
scale (not a multiply by its reciprocal; on the card the scale stays a
device tensor, since PyTorch turns a division by a host scalar into a
multiply), round half to even, a clamp to +-127, then int8. A grouped
conv is simulated as in the reference: the grid values contract in
float32.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from ..layers.quant_ops import pack_weight
from ..utils.config import ConfigError, NotPortedError, Roadmap

# the symmetric int8 grid keeps -128 out, so +/-amax map to +/-127 with
# one scale (fp8's e4m3 grid is not ported)
QMAX = {"int8": 127.0}

SERVE_DTYPES = ("float32", "bfloat16", "int8", "fp8")

QUANT_PREFIX = "quant/"

# graph layer types whose contraction quantizes (pallas_fullc keeps its
# own kernel path)
_QUANT_TYPES = {"conv": "conv", "fullc": "dot"}

# amax floor: a dead channel must not produce a zero scale
_AMAX_FLOOR = 1e-8

_DTYPE_ALIAS = {"f32": "float32", "bf16": "bfloat16", "float8": "fp8",
                "float8_e4m3": "fp8"}


def normalize_serve_dtype(val: str) -> str:
    """Canonical ``serve_dtype`` value (accepts the short aliases);
    ``fp8`` is not ported."""
    v = _DTYPE_ALIAS.get(val, val)
    if v not in SERVE_DTYPES:
        raise ConfigError("serve_dtype must be one of %s (got %r)"
                          % ("|".join(SERVE_DTYPES), val))
    if v == "fp8":
        raise NotPortedError("serve_dtype = fp8", Roadmap.QUANTIZED)
    return v


def quantize_tensor(v: torch.Tensor, scale: torch.Tensor, dtype: str,
                    native: bool) -> torch.Tensor:
    """Symmetric quantization onto the ``dtype`` grid: ``round(v /
    scale)`` half to even, clamped to +-QMAX; int8 when ``native``,
    else the grid values in float32. ``scale`` is a float32 tensor on
    v's device: per out channel (the last axis) for weights, 0-dim for
    activations."""
    qmax = QMAX[dtype]
    q = v.float() / scale
    torch.round(q, out=q)
    torch.clamp(q, -qmax, qmax, out=q)
    return q.to(torch.int8) if native else q


class QuantSpec:
    """Per-layer recipe pinned on the layer by :func:`attach`. ``dtype``
    is 'int8' or 'bfloat16'; the int8 scales are symmetric, per tensor for
    the activation (``x_scale``, a Python float) and per out channel for
    the weight (``w_scale``, a float32 tensor on the serving device)."""

    __slots__ = ("dtype", "x_scale", "w_scale", "native", "_x_scale_t")

    def __init__(self, dtype: str, x_scale: float = 1.0, w_scale=None,
                 native: bool = False):
        self.dtype = dtype
        self.x_scale = x_scale
        self.w_scale = w_scale
        self.native = native
        # float32(x_scale) as a device tensor: a true division on the card
        self._x_scale_t = None if w_scale is None else torch.tensor(
            np.float32(x_scale), device=w_scale.device)

    @property
    def is_affine(self) -> bool:
        return self.dtype == "int8"

    def dequant_vec(self) -> torch.Tensor:
        """Per-out-channel dequant factors ``w_scale * f32(x_scale)``
        (float32): the epilogue multiplies the accumulator by them."""
        return (self.w_scale * self._x_scale_t).float()

    def quantize_x(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_tensor(x, self._x_scale_t, self.dtype, self.native)

    def weight_operand(self, w: torch.Tensor) -> torch.Tensor:
        """A float weight in the reference layout (conv HWIO, fullc
        ``(in, out)``), quantized per out channel, in the layout the
        contraction reads: the packed int8 matrix when native; else the
        grid values, a conv's as PyTorch's OIHW (channels-last)."""
        wq = quantize_tensor(w, self.w_scale, self.dtype, self.native)
        if self.native:
            return pack_weight(wq)
        if wq.dim() == 4:
            return wq.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return wq


class QuantTarget(NamedTuple):
    li: int                              # layer (connection) index
    lkey: str                            # param layer key (table key)
    in_node: int                         # activation node calibrated
    kind: str                            # 'conv' | 'dot'


def quantizable(net) -> List[QuantTarget]:
    """The net's quantizable contractions: conv / fullc layers that own
    their params (shared primaries are excluded: one weight serving two
    sites would need two activation scales) and carry no channel_pad
    annotation (serving graphs run unpadded)."""
    g = net.graph
    shared_primaries = set(info.primary_layer_index
                           for info in g.layers if info.type == "share")
    out = []
    for li, info in enumerate(g.layers):
        kind = _QUANT_TYPES.get(info.type)
        if kind is None or li in shared_primaries:
            continue
        layer = net.layer_objs[li]
        if (getattr(layer, "_in_layout", None) is not None
                or getattr(layer, "_out_pad", 0)):
            continue
        out.append(QuantTarget(li, g.layer_key(li), info.nindex_in[0],
                               kind))
    return out


def folded_weight(trainer, li: int, lkey: str) -> np.ndarray:
    """Host copy of the weight as the eval graph contracts it: under
    ``bn_fold_eval`` the BN partner's running-stats scale is folded in,
    computed in numpy exactly as the reference's ``folded_weight``."""
    net, g = trainer.net, trainer.graph
    w = trainer.params[lkey]["wmat"].detach().cpu().numpy() \
        .astype(np.float32)
    if net.bn_fold_eval and li in net.fold_pairs:
        bn_li = net.fold_pairs[li]
        bn = net.layer_objs[bn_li]
        bkey = g.layer_key(g.param_layer_index(bn_li))
        bw = trainer.params[bkey]["wmat"].detach().cpu().numpy() \
            .astype(np.float32)
        bv = trainer.net_state[bkey]["running_var"].detach().cpu() \
            .numpy().astype(np.float32)
        w = w * (bw / np.sqrt(bv + bn.eps))
    return w


class Calibrator:
    """Streams eval batches through the net, recording per-channel
    activation amax at every quantizable layer's input: one eval
    forward per batch."""

    def __init__(self, trainer):
        if not trainer._initialized:
            raise RuntimeError("calibrate after init_model/load_model")
        self.trainer = trainer
        self.targets = quantizable(trainer.net)
        self._amax: Dict[str, np.ndarray] = {}
        self.batches = 0

    def observe(self, batch) -> None:
        """Fold one batch's activation ranges in. Padded tail rows are
        zeros: they never raise an amax."""
        t = self.trainer
        with torch.inference_mode():
            vals, _, _ = t.net.forward(t.params, t.net_state,
                                       t.to_device_batch(batch.data))
            vecs = []
            for tgt in self.targets:
                v = t.net.depad_node(tgt.in_node,
                                     vals[tgt.in_node]).float()
                vecs.append(v.abs().amax(dim=tuple(range(v.dim() - 1))))
        for tgt, v in zip(self.targets, vecs):
            a = v.cpu().numpy()
            cur = self._amax.get(tgt.lkey)
            self._amax[tgt.lkey] = a if cur is None else np.maximum(cur, a)
        self.batches += 1

    def finish(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Range tables: per-channel activation amax and per-out-channel
        amax of the eval-folded weights."""
        if self.batches == 0:
            raise RuntimeError("calibrate on at least one batch")
        tables: Dict[str, Dict[str, np.ndarray]] = {}
        for tgt in self.targets:
            w = folded_weight(self.trainer, tgt.li, tgt.lkey)
            w_amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
            tables[tgt.lkey] = {
                "x_amax": self._amax[tgt.lkey].astype(np.float32),
                "w_amax": w_amax.astype(np.float32),
            }
        return tables


def tables_from_blob(blob) -> Dict[str, Dict[str, np.ndarray]]:
    """Collect the ``quant/<layer>/<field>`` arrays of a snapshot."""
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    for k in blob:
        if not k.startswith(QUANT_PREFIX):
            continue
        lkey, field = k[len(QUANT_PREFIX):].rsplit("/", 1)
        tables.setdefault(lkey, {})[field] = np.asarray(blob[k])
    return tables


def attach(trainer) -> Dict[str, Any]:
    """Activate the trainer's ``serve_dtype`` on its layer objects and
    return the report: effective dtype, quantized layers, fallback
    layers (targets without a table), whether every contraction is
    native. float32 clears every spec; bfloat16 needs no tables; int8
    needs a calibrated snapshot and raises ``ValueError`` without
    one."""
    net = trainer.net
    for layer in net.layer_objs:
        layer._quant = None
    dtype = trainer.serve_dtype
    if dtype == "float32":
        return {"active": False}
    targets = quantizable(net)
    report = {"active": True, "dtype": dtype, "layers": 0,
              "fallback_layers": 0, "native": False}
    if dtype == "bfloat16":
        for tgt in targets:
            net.layer_objs[tgt.li]._quant = QuantSpec("bfloat16")
            report["layers"] += 1
        report["native"] = True
        return report
    tables = trainer.quant_tables
    if not tables:
        raise ValueError(
            "serve_dtype=%s needs a calibrated snapshot: calibrate this "
            "model first (Calibrator, then NetTrainer.set_quantization "
            "and save_model)" % dtype)
    qmax = QMAX[dtype]
    meta_fold = trainer.quant_meta.get("bn_fold_eval")
    if meta_fold is not None and bool(meta_fold) != net.bn_fold_eval:
        warnings.warn("snapshot was calibrated with bn_fold_eval=%s but "
                      "this config runs bn_fold_eval=%s; weight scales "
                      "were taken over the other graph"
                      % (meta_fold, net.bn_fold_eval))
    natives = []
    for tgt in targets:
        tab = tables.get(tgt.lkey)
        if tab is None or "x_amax" not in tab or "w_amax" not in tab:
            report["fallback_layers"] += 1
            continue
        x_scale = float(max(float(np.max(tab["x_amax"])),
                            _AMAX_FLOOR) / qmax)
        w_scale = np.maximum(tab["w_amax"].astype(np.float32),
                             _AMAX_FLOOR) / qmax
        # the int8 product into int32 (layers/quant_ops.py) runs on
        # every device; a grouped conv contracts the grid values in
        # float32 (the same values), as the reference's
        native = not (tgt.kind == "conv"
                      and net.layer_objs[tgt.li].param.num_group > 1)
        natives.append(native)
        net.layer_objs[tgt.li]._quant = QuantSpec(
            dtype, x_scale=x_scale,
            w_scale=torch.from_numpy(np.ascontiguousarray(w_scale))
            .to(trainer.device), native=native)
        report["layers"] += 1
    report["native"] = bool(natives) and all(natives)
    return report
