"""Spatial layers: convolution, pooling, batch norm (counterpart of
``cxxnet_tpu/layers/conv.py``), eval and training forwards.

- conv: one ``F.conv2d`` over an NCHW *view* of the NHWC activation
  (``permute(0, 3, 1, 2)``, channels-last strides) and a weight held in
  PyTorch's OIHW channels-last layout, converted once when the serve
  weights freeze; the output permutes back to a dense NHWC tensor with
  no copy. The reference's three lowerings (pointwise-as-matmul,
  space-to-depth entry rewrite, general conv) compute the same
  function and all map to that one call.
- the batch-norm fold (``bn_fold_eval``) either multiplies the weight
  (``conv_pallas_epilogue = 0``) or runs on the conv output as one
  launch of the ``conv_epilogue`` kernel (``conv_pallas_epilogue = 1``).
- ``serve_dtype = int8`` (eval only): the fold multiplies the weight
  before it is quantized; the activation quantizes on the device, the
  int8 product accumulates in int32 (``quant_ops.conv_int8``) and the
  conv_epilogue kernel applies the per-channel dequant, the folded
  shift and the relu to the int32 accumulator. ``serve_dtype =
  bfloat16`` and ``dtype = bfloat16`` (eval and training): the conv
  runs on bf16 operands, its output (and its epilogue's) stays bf16,
  and so the activations ride bf16 through batch norm, relu and the
  pools to the loss.
- ``relu_max_pooling`` fuses a relu before the max pool; where the
  reference's gate holds (stride 1, no pad, square window > 1) and
  ``pallas_pool = 1`` or the layer is ``pallas_relu_max_pooling``, it
  runs as the relu_max_pool kernels (forward and backward; the
  backward credits every tied maximum). Otherwise relu, then the pool
  below (ties to the first maximum, as XLA's select-and-scatter).
- pooling keeps the reference's ceil-mode output size and border rules
  (``_pool_out_dim``): the base pad is a zero pad, the ceil overhang a
  truncated window (``-inf`` for max), and avg divides by the full
  ``kh * kw``. PyTorch's ``ceil_mode`` and ``count_include_pad`` do not
  give these rules, so the pads are explicit. (For avg they must be:
  with the pad inside the op, ``F.avg_pool2d``'s CUDA backward is wrong
  in PyTorch 2.11 / CUDA 12.8 while its forward is right; see
  ROADMAP.md queue 3.)
- training: the master conv weight stays HWIO (the snapshot layout);
  the OIHW operand cuDNN takes is derived from it on every step under
  autograd, so its gradient arrives in HWIO. Batch norm normalizes
  with the masked single-pass batch moments and applies the folded
  scale/shift through the ``bn_apply`` kernel under ``bn_pallas = 1``;
  the gradient through the moments is plain autograd, as it is XLA in
  the reference. Under ``dtype = bfloat16`` the moments are taken in
  f32 from the bf16 input, scale and shift are made in f32, and
  ``bn_apply`` applies them in bf16; the eval normalize promotes to
  f32 and casts back (the reference's asymmetry, kept).
- ``channel_pad`` (``nnet/layout.py`` annotates the layers): a conv
  scatters zero weight rows into a padded input's gaps
  (``_in_layout``) and appends zero weight columns and zero bias
  entries for an aligned output (``_out_pad``); batch norm
  (``_layout``) pads slope and bias (and, at eval, the folded scale
  and shift) with zeros, so a padded channel comes out exactly 0, and
  keeps its running statistics logical.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..nnet.layout import pad_channel_vec, take_valid
from . import common
from .base import Layer, Shape3
from .kernels import (bias_add, bn_apply, bn_apply_plain, conv_epilogue,
                      conv_epilogue_plain, relu_max_pool, scale_mul)
from .quant_ops import conv_int8


def _conv_out_dim(size: int, pad: int, k: int, stride: int) -> int:
    # floor mode
    return (size + 2 * pad - k) // stride + 1


def _pool_out_dim(size: int, pad: int, k: int, stride: int) -> int:
    # ceil mode, window start clamped
    return min(size + 2 * pad - k + stride - 1, size + 2 * pad - 1) \
        // stride + 1


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO weight (the snapshot layout) -> PyTorch's OIHW, stored
    channels-last so cuDNN reads it without a transpose."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


class ConvolutionLayer(Layer):
    """Grouped 2-D convolution; weights HWIO (kh, kw, in_ch/group, out_ch).

    Params the eval forward understands beyond ``wmat``/``bias``:

    - ``_oihw``: the weight converted for ``F.conv2d`` (frozen serve
      tree); without it ``wmat`` converts on every call;
    - ``_ep_scale``/``_ep_shift`` (+ ``_ep_relu``): the frozen BN fold
      applied by the conv_epilogue kernel, bias already in the shift;
    - ``_r_shift``/``_r_shift_relu``: the frozen weight-side fold, the
      effective shift added after the conv;
    - ``_wq`` + ``_r_dequant`` (``serve_dtype = int8``): the folded
      weight quantized once (``QuantSpec.weight_operand``) and the
      per-channel dequant; the shift then goes to the epilogue;
    - ``_fold_scale``/``_fold_shift`` (+ ``_fold_relu``): the fold as the
      net injects it per forward when the serve weights are not frozen.
    """

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        p = self.param
        if p.num_channel <= 0:
            raise ValueError("conv: must set nchannel correctly")
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("conv: must set kernel_size correctly")
        if s.ch % p.num_group != 0 or p.num_channel % p.num_group != 0:
            raise ValueError("conv: channels must divide group size")
        if p.kernel_width > s.x or p.kernel_height > s.y:
            raise ValueError("conv: kernel size exceeds input")
        if p.num_input_channel == 0:
            p.num_input_channel = s.ch
        elif p.num_input_channel != s.ch:
            raise ValueError("conv: input channel count not consistent")
        oy = _conv_out_dim(s.y, p.pad_y, p.kernel_height, p.stride)
        ox = _conv_out_dim(s.x, p.pad_x, p.kernel_width, p.stride)
        self.in_shapes = [s]
        self.out_shapes = [Shape3(p.num_channel, oy, ox)]
        return self.out_shapes

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        p = self.param
        in_pg = p.num_input_channel // p.num_group
        shape = (p.kernel_height, p.kernel_width, in_pg, p.num_channel)
        # fan convention of the reference's GEMM view: fan = (in, out)
        # per filter
        fan_in = in_pg * p.kernel_height * p.kernel_width
        fan_out = p.num_channel // p.num_group
        out = {"wmat": p.rand_init_weight(gen, shape, fan_in, fan_out)}
        if p.no_bias == 0:
            out["bias"] = torch.full((p.num_channel,), p.init_bias,
                                     dtype=torch.float32)
        return out

    # channel_pad annotations (nnet/layout.py): the padded input's
    # segment map, and the zero channels appended to the output
    _in_layout = None
    _out_pad = 0

    def _physical_weight(self, w: torch.Tensor) -> torch.Tensor:
        """The HWIO weight with zero rows in a padded input's gaps and
        zero columns for the output padding: provably-zero extensions
        of the same contraction."""
        if self._in_layout is not None:
            parts, off = [], 0
            for valid, pad in self._in_layout:
                parts.append(w[:, :, off:off + valid, :])
                if pad:
                    parts.append(w.new_zeros(w.shape[:2]
                                             + (pad, w.shape[3])))
                off += valid
            w = torch.cat(parts, dim=2)
        if self._out_pad:
            w = F.pad(w, (0, self._out_pad))
        return w

    def _physical_bias(self, b: torch.Tensor) -> torch.Tensor:
        """A per-out-channel vector with zeros for the output padding."""
        return F.pad(b, (0, self._out_pad)) if self._out_pad else b

    def conv(self, x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out, through one F.conv2d on NCHW views."""
        p = self.param
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=p.stride,
                     padding=(p.pad_y, p.pad_x), groups=p.num_group)
        return y.permute(0, 2, 3, 1)

    def _conv_quant(self, q, x: torch.Tensor,
                    wq: torch.Tensor) -> torch.Tensor:
        """The quantized contraction: x quantized on its device, then
        the int8 product into int32 (``q.native``), or the grid values
        in float32 (a grouped conv); ``wq`` is ``q.weight_operand``."""
        p = self.param
        xq = q.quantize_x(x)
        if q.native:
            return conv_int8(xq, wq, p.num_channel, p.kernel_height,
                             p.kernel_width, p.stride, p.pad_y, p.pad_x)
        return self.conv(xq, wq)

    def _epilogue(self, y, scale, shift, relu, out_dtype):
        """``relu?(float(y) * scale + shift)`` cast to ``out_dtype``: one
        conv_epilogue launch under ``conv_pallas_epilogue``, else the
        plain arithmetic."""
        if self.param.conv_pallas_epilogue:
            return conv_epilogue(y.contiguous(), scale, shift, relu,
                                 out_dtype)
        return conv_epilogue_plain(y, scale, shift, relu, out_dtype)

    def forward(self, params, state, inputs, is_train=False):
        p = self.param
        x = inputs[0]
        bf16 = p.compute_dtype == "bfloat16"
        if is_train:
            # no fold: the training forward is conv + bias on the masters
            # (or their bf16 shadow); under dtype = bfloat16 both
            # operands and the output are bf16
            w = params["wmat"]
            if bf16:
                x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            y = self.conv(x, hwio_to_oihw(self._physical_weight(w)))
            if p.no_bias == 0:
                y = bias_add(y, self._physical_bias(params["bias"]))
            return [y], state
        # the serve_dtype spec (nnet/quantize.attach): int8 contracts
        # quantized operands, bfloat16 (or dtype = bfloat16) runs the
        # conv and its epilogue in bf16 (the activations stay bf16
        # between layers)
        q = self._quant
        quant = q is not None and q.is_affine
        bf16 = bf16 or (q is not None and q.dtype == "bfloat16")
        out_dtype = torch.bfloat16 if bf16 else torch.float32
        shift = params.get("_r_shift")
        relu = False
        if shift is None:
            shift = params.get("_r_shift_relu")
            relu = shift is not None
        dq = params.get("_r_dequant")
        if dq is not None:
            # frozen quantized weight (folded before it was quantized):
            # the int32 accumulator through the epilogue with the dequant
            y = self._conv_quant(q, x, params["_wq"])
            return [self._epilogue(y, dq, shift, relu, out_dtype)], state
        w = params.get("_oihw")
        if bf16 and not quant:
            x = x.to(torch.bfloat16)
        if shift is not None:
            # frozen weight-side fold: the weight was multiplied once
            y = self.conv(x, w) + shift.to(x.dtype)
            return [torch.relu(y) if relu else y], state
        ep_scale = params.get("_ep_scale")
        if ep_scale is not None:
            # frozen output-side fold: one conv_epilogue launch
            y = self.conv(x, w)
            return [self._epilogue(y, ep_scale, params["_ep_shift"],
                                   "_ep_relu" in params, out_dtype)], state
        # no frozen fold: the fold (if any) computed by the net for this
        # forward, the weight converted (and quantized) here unless it
        # was frozen raw
        fold_scale = params.get("_fold_scale")
        fold_in_epilogue = (fold_scale is not None and not quant
                            and bool(p.conv_pallas_epilogue)
                            and not self._out_pad)
        if quant or w is None or (fold_scale is not None
                                  and not fold_in_epilogue):
            w = params["wmat"]
            if fold_scale is not None and not fold_in_epilogue:
                w = w * fold_scale
            w = q.weight_operand(w) if quant \
                else hwio_to_oihw(self._physical_weight(w))
            if bf16 and not quant:
                w = w.to(torch.bfloat16)
        y = self._conv_quant(q, x, w) if quant else self.conv(x, w)
        if fold_scale is not None:
            b = params["_fold_shift"]
            if p.no_bias == 0:
                b = b + params["bias"] * fold_scale
        elif p.no_bias == 0:
            b = params["bias"]
        else:
            b = None
        relu = fold_scale is not None and "_fold_relu" in params
        ep_scale = q.dequant_vec() if quant \
            else (fold_scale if fold_in_epilogue else None)
        if ep_scale is not None:
            shift = b if b is not None else torch.zeros_like(ep_scale)
            return [self._epilogue(y, ep_scale, shift, relu, out_dtype)], \
                state
        if b is not None:
            y = y + self._physical_bias(b).to(y.dtype)
        return [torch.relu(y) if relu else y], state


def relu_max_pool_applicable(param) -> bool:
    """The reference's gate for the fused kernels
    (``pallas_kernels.relu_max_pool_applicable``): stride-1 VALID
    square max pools with a real window."""
    return (param.stride == 1 and param.pad_y == 0 and param.pad_x == 0
            and param.kernel_height == param.kernel_width
            and param.kernel_height > 1)


def xla_window_sum_order(kh: int, kw: int, stride: int, pad: int, w: int,
                         ox: int) -> List[tuple]:
    """The order in which the reference's XLA:CPU build adds the kh x kw
    window of a bf16 avg pool (``reduce_window`` add with low pad
    ``pad`` on an input ``w`` wide, ``ox`` outputs across), as
    ``(di, dj)`` offsets.

    XLA:CPU emits the window as a loop nest, row outer and column
    inner, each element checked against the unpadded input. Before it
    emits the nest it tries to peel the column loop's last iteration:
    when the column index enters a bounds check and would no longer
    after the peel, it adds columns 0..kw-2 of every row first, row by
    row, then column kw-1 from the top. The column index enters a check
    when the padded positions it can reach, ``[0, (ox - 1) * stride +
    kw - 1]``, do not lie inside the input's ``[pad, pad + w - 1]``; a
    column range of one offset (kw = 2 after the peel) is a constant
    and enters none. So every kw = 2 pool with a pad or an overhang,
    and every pad-0 pool whose overhang is one column, adds column by
    column's last; every other pool adds row-major. Only the columns
    decide: the rule was read on square windows with equal pads and on
    windows with kh != kw or pad_y != pad_x (kh and kw 2-4,
    ``tests/test_torch_port_avg_pool.py``)."""
    def reaches_out(last: int) -> bool:
        return not (pad <= 0 and (ox - 1) * stride + last <= pad + w - 1)
    peel = kw >= 2 and reaches_out(kw - 1) \
        and (kw == 2 or not reaches_out(kw - 2))
    if not peel:
        return [(di, dj) for di in range(kh) for dj in range(kw)]
    return [(di, dj) for di in range(kh) for dj in range(kw - 1)] \
        + [(di, kw - 1) for di in range(kh)]


class PoolingLayer(Layer):
    """max / sum / avg pooling with the reference's ceil-mode shape
    rules.

    ``pre_relu`` fuses a relu before the pool (``relu_max_pooling``);
    ``use_pallas`` (``pallas_relu_max_pooling``) or the ``pallas_pool``
    key sends it through the relu_max_pool kernels where their gate
    holds."""

    def __init__(self, mode: str, cfg=(), pre_relu: bool = False,
                 use_pallas: bool = False):
        self.mode = mode
        self.pre_relu = pre_relu
        self.use_pallas = use_pallas
        super().__init__(cfg)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        p = self.param
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("pooling: must set kernel_size correctly")
        if p.kernel_width > s.x or p.kernel_height > s.y:
            raise ValueError("pooling: kernel size exceeds input")
        oy = _pool_out_dim(s.y, p.pad_y, p.kernel_height, p.stride)
        ox = _pool_out_dim(s.x, p.pad_x, p.kernel_width, p.stride)
        self.in_shapes = [s]
        self.out_shapes = [Shape3(s.ch, oy, ox)]
        return self.out_shapes

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        p = self.param
        kh, kw, st = p.kernel_height, p.kernel_width, p.stride
        oy, ox = self.out_shapes[0].y, self.out_shapes[0].x
        py, px = p.pad_y, p.pad_x
        # the ceil overhang beyond the (base-padded) input
        ey = max(0, (oy - 1) * st + kh - (x.shape[1] + 2 * py))
        ex = max(0, (ox - 1) * st + kw - (x.shape[2] + 2 * px))
        if self.mode == "max":
            # zero base pad, then the overhang as -inf (truncated windows)
            if py or px:
                x = F.pad(x, (0, 0, px, px, py, py))
            if ey or ex:
                x = F.pad(x, (0, 0, 0, ex, 0, ey), value=float("-inf"))
            y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), st)
        else:
            # zero pad; avg divides every window by kh*kw, sum does not
            avg = self.mode == "avg"
            order = xla_window_sum_order(kh, kw, st, px, x.shape[2], ox)
            if py or px or ey or ex:
                x = F.pad(x, (0, 0, px, px + ex, py, py + ey))
            if x.dtype == torch.bfloat16:
                return self._bf16_window_sum(x, kh, kw, st, oy, ox, order,
                                             avg)
            y = F.avg_pool2d(x.permute(0, 3, 1, 2), (kh, kw), st,
                             divisor_override=kh * kw if avg else 1)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def _bf16_window_sum(x, kh, kw, st, oy, ox, order, avg):
        """Sum (or, with ``avg``, average) pool of a padded bf16 NHWC
        tensor in the reference's arithmetic: ``reduce_window``'s add in
        bf16, one rounding per add, the window offsets in ``order``
        (:func:`xla_window_sum_order`), then for avg the product with ``1
        / (kh * kw)`` rounded to bf16 (``F.avg_pool2d`` sums in float32
        and divides, which differs in up to half the entries by up to 1.5
        %). The window slices are taken in row-major order whatever
        the order of the adds, so autograd accumulates their gradients
        last offset first, as the reference's VJP adds them."""
        terms = {(di, dj): x[:, di:di + (oy - 1) * st + 1:st,
                             dj:dj + (ox - 1) * st + 1:st]
                 for di in range(kh) for dj in range(kw)}
        # from +0, as reduce_window's init: a window of -0 sums to +0
        y = terms[order[0]] + 0.0
        for key in order[1:]:
            y = y + terms[key]
        if not avg:
            return y
        # 1/(kh*kw) rounded to bf16, exact as a Python float
        return y * float(torch.tensor(1.0 / (kh * kw), dtype=torch.bfloat16))

    def forward(self, params, state, inputs, is_train=False):
        x = inputs[0]
        if self.pre_relu:
            p = self.param
            if ((self.use_pallas or p.pallas_pool) and self.mode == "max"
                    and relu_max_pool_applicable(p)):
                return [relu_max_pool(x, p.kernel_height)], state
            x = torch.relu(x)
        return [self._pool(x)], state


class InsanityPoolingLayer(PoolingLayer):
    """Stochastic-displacement max pooling (``insanity_max_pooling``):
    in training each input pixel is replaced by its neighbour above,
    below, left or right (clamped at the edges) with probability (1 -
    keep) / 4 each, from one uniform draw per element
    (``common.dropout_uniform``), then the ceil-mode pool runs over the
    displaced map; inference is the plain pool. A pad is refused in
    training, as the reference refuses it."""

    needs_rng = True

    def __init__(self, mode: str, cfg=()):
        self.p_keep = 1.0
        super().__init__(mode, cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "keep":
            self.p_keep = float(val)

    def forward(self, params, state, inputs, is_train=False, rng=None):
        x = inputs[0]
        if not is_train:
            return [self._pool(x)], state
        if self.param.pad_y or self.param.pad_x:
            raise ValueError("insanity pooling: pad unsupported in training "
                             "(matches reference behavior)")
        if rng is None:
            raise ValueError("insanity pooling needs the step's rng in "
                             "training")
        flag = common.dropout_uniform(x.shape, rng, x.device)
        k = self.p_keep
        delta = (1.0 - k) / 4.0
        # the shifted copies with edge clamping, in the reference's order
        up = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        left = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
        right = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
        # thresholds rounded to float32, as the reference compares them
        t0, t1, t2, t3 = (float(np.float32(k + i * delta)) for i in range(4))
        displaced = torch.where(
            flag < t0, x,
            torch.where(flag < t1, up,
                        torch.where(flag < t2, down,
                                    torch.where(flag < t3, left, right))))
        return [self._pool(displaced)], state


class LRNLayer(Layer):
    """Local response normalization across channels (``lrn``):
    ``x * (knorm + alpha / nsize * sum(x^2 over the window))^-beta``,
    the window ``[c - h, c + h]`` (h = nsize // 2) clipped at the edges.

    The arithmetic is the reference's, step by step: x² (cast to bf16
    under ``dtype = bfloat16``), zero-padded by h on both sides of the
    channel axis, then the 2h+1 shifted slices added in slice order (in
    bf16 under bf16, one rounding per add), cast to float32, times
    ``alpha / nsize`` plus ``knorm``; at ``beta = 0.75`` the factor is
    ``rsqrt(n) * rsqrt(sqrt(n))``, otherwise ``pow(n, -beta)``; the
    factor is cast to x's dtype and multiplies x. Autograd
    differentiates it; the shifted slices' cotangents accumulate last
    slice first, as the reference's VJP adds them. (The reference's
    float32 ``rsqrt`` is XLA:CPU's hardware estimate refined by two
    Newton steps, and its multiply-adds fuse; the port's float32 result
    lies within a few ulps of it.)"""

    def __init__(self, cfg=()):
        self.nsize = 3
        self.alpha = 0.001
        self.beta = 0.75
        self.knorm = 1.0
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "local_size":
            self.nsize = int(val)
        if name == "alpha":
            self.alpha = float(val)
        if name == "beta":
            self.beta = float(val)
        if name == "knorm":
            self.knorm = float(val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        x = inputs[0]
        sq = x * x
        h = self.nsize // 2
        if self.param.compute_dtype == "bfloat16":
            sq = sq.to(torch.bfloat16)
        pad = F.pad(sq, (h, h))
        c = x.shape[-1]
        norm = pad[..., 0:c]
        for i in range(1, 2 * h + 1):
            norm = norm + pad[..., i:i + c]
        wide = torch.promote_types(norm.dtype, torch.float32)
        norm = norm.to(wide) * (self.alpha / self.nsize) + self.knorm
        if self.beta == 0.75:
            scale = torch.rsqrt(norm) * torch.rsqrt(torch.sqrt(norm))
        else:
            scale = torch.pow(norm, -self.beta)
        return [x * scale.to(x.dtype)], state


class BatchNormLayer(Layer):
    """Batch normalization, both of the reference's variants: with
    moving averages (``batch_norm``; with ``use_pallas``,
    ``pallas_batch_norm``) and without (``batch_norm_no_ma``,
    ``moving_avg = False``). Per channel on spatial nodes, per feature
    on matrix nodes; eps default 1e-10, running average momentum 0.9.

    Training normalizes with the batch moments, padded tail rows
    excluded through the mask, and updates the running stats; eval
    normalizes with the running stats, or, without moving averages
    (which keep no state), with the masked moments of the batch it is
    given (the reference's behaviour)."""

    needs_mask = True

    def __init__(self, cfg=(), use_pallas: bool = False,
                 moving_avg: bool = True):
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10
        self.bn_momentum = 0.9
        self.channel = 0
        self.moving_avg = moving_avg
        self.use_pallas = use_pallas
        # set by the net's bn_fuse_relu pass: the relu consuming this
        # BN's output runs inside this layer
        self.fuse_relu = False
        # set by the channel_pad pass: the input's (valid, pad) segments
        self._layout = None
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "init_bias":
            self.init_bias = float(val)
        if name == "eps":
            self.eps = float(val)
        if name == "bn_momentum":
            self.bn_momentum = float(val)
        if name == "bn_pallas":
            self.use_pallas = bool(int(val))

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.channel = s.x if s.is_mat else s.ch
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return {
            "wmat": torch.full((self.channel,), self.init_slope,
                               dtype=torch.float32),
            "bias": torch.full((self.channel,), self.init_bias,
                               dtype=torch.float32),
        }

    def init_state(self) -> Dict[str, torch.Tensor]:
        if not self.moving_avg:
            return {}
        # the reference initializes running stats to zero
        return {
            "running_exp": torch.zeros(self.channel, dtype=torch.float32),
            "running_var": torch.zeros(self.channel, dtype=torch.float32),
        }

    def fold(self, params, state):
        """Per-channel (scale, shift) of the eval normalization from the
        running stats (see :meth:`_fold`)."""
        return self._fold(params, state["running_exp"], state["running_var"])

    def _fold(self, params, mean, var):
        """(scale, shift) of a normalization by ``mean`` and ``var``. The
        factor ``rsqrt(var + eps)`` is taken in float64 and rounded once
        to float32, so the card folds as the CPU does: CUDA's float32
        rsqrt is an approximation and PyTorch's CPU one rounds a sqrt
        first, and under ``serve_dtype = int8`` an ulp in the folded
        weight can move an int8 weight by one step."""
        inv = torch.rsqrt((var + self.eps).double())
        scale = params["wmat"] * inv.to(params["wmat"].dtype)
        return scale, params["bias"] - mean * scale

    @staticmethod
    def _moments(x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Single-pass masked moments, E[x²] - E[x]² in f32, clamped at
        0 (the reference's ``_moments``, term for term). A float64 net
        (a precision check's witness) keeps float64."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            n = float(x.numel() // x.shape[-1])
            s1 = xf.sum(axes)
            s2 = (xf * xf).sum(axes)
        else:
            w = mask.reshape((-1,) + (1,) * (x.dim() - 1))
            n = mask.sum() * (x.numel() // (x.shape[0] * x.shape[-1]))
            n = torch.clamp_min(n, 1.0)
            s1 = (xf * w).sum(axes)
            s2 = (xf * xf * w).sum(axes)
        mean = s1 / n
        var = s2 / n - mean * mean
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        return mean, torch.maximum(var, torch.zeros_like(var))

    def _apply(self, x, scale, shift):
        """The folded per-channel epilogue (+ fused relu), through the
        bn_apply kernel under ``bn_pallas``. Without it, a bf16 x takes
        ``x * bf16(scale) + bf16(shift)`` in bf16 with the reference's
        gradients of scale and shift: bf16 sums in XLA:CPU's order
        (``kernels.scale_mul``, ``kernels.bias_add``)."""
        if self.use_pallas:
            return bn_apply(x, scale, shift, self.fuse_relu)
        if x.dtype != torch.bfloat16:
            return bn_apply_plain(x, scale, shift, self.fuse_relu)
        y = bias_add(scale_mul(x, scale), shift)
        return torch.relu(y) if self.fuse_relu else y

    def forward(self, params, state, inputs, is_train=False, mask=None):
        x = inputs[0]
        slope, bias = params["wmat"], params["bias"]
        layout = self._layout
        if layout is not None:
            # zeros in the pad gaps: a padded channel comes out 0*x + 0
            # and its cotangent vanishes
            slope = pad_channel_vec(slope, layout)
            bias = pad_channel_vec(bias, layout)
        if not is_train:
            # the eval normalize in (at least) f32, cast back to x's
            # dtype, as the reference's eval path does
            if self.moving_avg:
                scale, shift = self.fold(params, state)
            else:
                mean, var = self._moments(x, mask)
                if layout is not None:
                    mean, var = take_valid(mean, layout), \
                        take_valid(var, layout)
                scale, shift = self._fold(params, mean, var)
            if layout is not None:
                scale = pad_channel_vec(scale, layout)
                shift = pad_channel_vec(shift, layout)
            wide = torch.promote_types(x.dtype, scale.dtype)
            out = (x.to(wide) * scale + shift).to(x.dtype)
            return [torch.relu(out) if self.fuse_relu else out], state
        mean, var = self._moments(x, mask)
        if self.param.bn_fold_affine:
            scale = slope * torch.rsqrt(var + self.eps)
            shift = bias - mean * scale
            out = self._apply(x, scale, shift)
        else:
            xhat = (x - mean) * torch.rsqrt(var + self.eps)
            out = (xhat * slope + bias).to(x.dtype)
            if self.fuse_relu:
                out = torch.relu(out)
        if not self.moving_avg:
            return [out], state
        m = self.bn_momentum
        if layout is not None:           # the state stays logical
            mean, var = take_valid(mean, layout), take_valid(var, layout)
        with torch.no_grad():
            state = dict(
                state,
                running_exp=state["running_exp"] * m + mean * (1 - m),
                running_var=state["running_var"] * m + var * (1 - m))
        return [out], state
