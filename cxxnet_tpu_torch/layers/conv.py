"""Spatial layers: convolution, pooling, batch norm (counterpart of
``cxxnet_tpu/layers/conv.py``), eval forwards only.

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
- pooling keeps the reference's ceil-mode output size and border rules
  (``_pool_out_dim``): the base pad is a zero pad, the ceil overhang a
  truncated window (``-inf`` for max), and avg divides by the full
  ``kh * kw``. PyTorch's ``ceil_mode`` and ``count_include_pad`` do not
  give these rules, so the pads are explicit.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..utils.config import NotPortedError, Roadmap
from .base import Layer, Shape3
from .kernels import conv_epilogue


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

    def conv(self, x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out, through one F.conv2d on NCHW views."""
        p = self.param
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=p.stride,
                     padding=(p.pad_y, p.pad_x), groups=p.num_group)
        return y.permute(0, 2, 3, 1)

    def forward(self, params, state, inputs):
        p = self.param
        x = inputs[0]
        w = params.get("_oihw")
        shift = params.get("_r_shift")
        relu = False
        if shift is None:
            shift = params.get("_r_shift_relu")
            relu = shift is not None
        if shift is not None:
            # frozen weight-side fold: the weight was multiplied once
            y = self.conv(x, w) + shift
            return [torch.relu(y) if relu else y]
        ep_scale = params.get("_ep_scale")
        if ep_scale is not None:
            # frozen output-side fold: one conv_epilogue launch
            y = self.conv(x, w)
            return [conv_epilogue(y, ep_scale, params["_ep_shift"],
                                  "_ep_relu" in params, torch.float32)]
        # no frozen fold: the fold (if any) computed by the net for this
        # forward, the weight converted here unless it was frozen raw
        fold_scale = params.get("_fold_scale")
        fold_in_epilogue = fold_scale is not None \
            and bool(p.conv_pallas_epilogue)
        if w is None or (fold_scale is not None and not fold_in_epilogue):
            w = params["wmat"]
            if fold_scale is not None and not fold_in_epilogue:
                w = w * fold_scale
            w = hwio_to_oihw(w)
        y = self.conv(x, w)
        if fold_scale is not None:
            b = params["_fold_shift"]
            if p.no_bias == 0:
                b = b + params["bias"] * fold_scale
        elif p.no_bias == 0:
            b = params["bias"]
        else:
            b = None
        relu = fold_scale is not None and "_fold_relu" in params
        if fold_in_epilogue:
            shift = b if b is not None else torch.zeros_like(fold_scale)
            return [conv_epilogue(y, fold_scale, shift, relu,
                                  torch.float32)]
        if b is not None:
            y = y + b
        return [torch.relu(y) if relu else y]


class PoolingLayer(Layer):
    """max / avg pooling with the reference's ceil-mode shape rules."""

    def __init__(self, mode: str, cfg=()):
        self.mode = mode
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
        elif not (ey or ex) and py <= kh // 2 and px <= kw // 2:
            # zero pad inside the op, every window divided by kh*kw
            y = F.avg_pool2d(x.permute(0, 3, 1, 2), (kh, kw), st,
                             padding=(py, px), count_include_pad=True)
        else:
            x = F.pad(x, (0, 0, px, px + ex, py, py + ey))
            y = F.avg_pool2d(x.permute(0, 3, 1, 2), (kh, kw), st,
                             divisor_override=kh * kw)
        return y.permute(0, 2, 3, 1)

    def forward(self, params, state, inputs):
        return [self._pool(inputs[0])]


class BatchNormLayer(Layer):
    """Batch normalization with moving averages (``batch_norm``); at
    eval it normalizes with the running stats. Per channel on spatial
    nodes, per feature on matrix nodes; eps default 1e-10."""

    def __init__(self, cfg=()):
        self.init_slope = 1.0
        self.init_bias = 0.0
        self.eps = 1e-10
        self.bn_momentum = 0.9
        self.channel = 0
        self.moving_avg = True
        # set by the net's bn_fuse_relu pass: the relu consuming this
        # BN's output runs inside this layer
        self.fuse_relu = False
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
        if name == "bn_pallas" and int(val):
            raise NotPortedError("bn_pallas = %s" % val, Roadmap.BN_APPLY)

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
        # the reference initializes running stats to zero
        return {
            "running_exp": torch.zeros(self.channel, dtype=torch.float32),
            "running_var": torch.zeros(self.channel, dtype=torch.float32),
        }

    def fold(self, params, state):
        """Per-channel (scale, shift) of the eval normalization."""
        scale = params["wmat"] * torch.rsqrt(state["running_var"]
                                             + self.eps)
        return scale, params["bias"] - state["running_exp"] * scale

    def forward(self, params, state, inputs):
        x = inputs[0]
        scale, shift = self.fold(params, state)
        out = x * scale + shift
        return [torch.relu(out) if self.fuse_relu else out]
