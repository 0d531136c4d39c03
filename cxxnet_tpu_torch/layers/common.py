"""Dense / elementwise / structural layers (counterpart of
``cxxnet_tpu/layers/common.py``); one forward for evaluation and
training, differentiated by autograd:

- fullc        — y = x @ W + b, W stored (in, out); at eval under
  ``serve_dtype = int8`` an int8 product into int32, dequantized per out
  channel; under ``serve_dtype = bfloat16`` or ``dtype = bfloat16`` a
  product of bf16 operands (bf16 output)
- pallas_fullc — the same through the matmul kernel
  (``PallasFullConnectLayer``, counterpart of the reference's in
  ``pallas_kernels.py:543-559``), whose output is float32 also on bf16
  operands. A bias on a bf16 output adds through ``kernels.bias_add``,
  whose gradient sums in bf16 in the reference's order
- flatten      — NHWC -> (batch, ch*y*x) in the reference's NCHW order
- relu/sigmoid/tanh/softplus
- dropout      — inverted dropout in training, identity at inference
  (self-loop); the mask's uniform draw comes from
  :func:`dropout_uniform`
- concat/ch_concat — under the net's ``pool_concat_pallas`` pass a
  ch_concat whose pool branch fused into it runs as the pool_concat
  kernel
- split
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .base import Layer, Shape3, StepKey, as_mat
from .kernels import bias_add, matmul, pool_concat
from .quant_ops import dot_int8


def dropout_uniform(shape: Sequence[int], key: StepKey,
                    device: torch.device) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of ``shape`` on ``device`` for the
    dropout mask of one layer in one step, from a ``torch.Generator`` on
    that device seeded by ``key``. The one place dropout's randomness
    comes from: a parity test replaces it to feed the reference's
    draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key.generator_seed())
    return torch.rand(tuple(shape), generator=gen, device=device)


class FullConnectLayer(Layer):
    """y = x @ W + b with W stored (in_features, num_hidden), the
    reference package's layout; the reference-convention transpose
    happens only at the weight get/set API (trainer.get_weight)."""

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        if not s.is_mat:
            raise ValueError("fullc: input must be a matrix (flatten first)")
        if self.param.num_hidden <= 0:
            raise ValueError("fullc: must set nhidden correctly")
        if self.param.num_input_node == 0:
            self.param.num_input_node = s.x
        elif self.param.num_input_node != s.x:
            raise ValueError("fullc: input hidden nodes not consistent")
        self.in_shapes = [s]
        self.out_shapes = [Shape3(1, 1, self.param.num_hidden)]
        return self.out_shapes

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        p = self.param
        wmat = p.rand_init_weight(gen, (p.num_input_node, p.num_hidden),
                                  p.num_input_node, p.num_hidden)
        out = {"wmat": wmat}
        if p.no_bias == 0:
            out["bias"] = torch.full((p.num_hidden,), p.init_bias,
                                     dtype=torch.float32)
        return out

    def _matmul(self, x, w):
        return x @ w

    def forward(self, params, state, inputs, is_train=False):
        x = inputs[0]
        # the serve_dtype spec (nnet/quantize.attach), eval only: int8
        # contracts the quantized operands into int32 and dequantizes
        # per out channel; bfloat16 multiplies bf16 operands
        q = None if is_train else self._quant
        if q is not None and q.is_affine:
            dq = params.get("_r_dequant")
            if dq is None:               # not frozen: quantize per call
                wq, dq = q.weight_operand(params["wmat"]), q.dequant_vec()
            else:
                wq = params["_wq"]
            xq = q.quantize_x(x)
            y = dot_int8(xq, wq, self.param.num_hidden) if q.native \
                else xq @ wq
            y = y.float() * dq
            if self.param.no_bias == 0:
                y = y + params["bias"]
            return [y], state
        w = params["wmat"]
        if self.param.compute_dtype == "bfloat16" or (
                q is not None and q.dtype == "bfloat16"):
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        y = self._matmul(x, w)
        if self.param.no_bias == 0:
            y = bias_add(y, params["bias"])
        return [y], state


class PallasFullConnectLayer(FullConnectLayer):
    """fullc with the product through the matmul kernel (config name
    ``pallas_fullc``); the same function as ``fullc``. The forward and
    both backward products are kernel launches; the bias add is plain."""

    def _matmul(self, x, w):
        return matmul(x, w)


class FlattenLayer(Layer):
    """Reshape (b,y,x,ch) -> (b, ch*y*x) in reference NCHW c-order."""

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [Shape3(1, 1, s.flat_size)]
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        return [as_mat(inputs[0])], state


class ActivationLayer(Layer):
    """Elementwise activation."""

    _FNS = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        # threshold off: log(1 + exp(x)) everywhere, like jax.nn.softplus
        "softplus": lambda x: F.softplus(x, threshold=float("inf")),
    }

    def __init__(self, kind: str, cfg=()):
        self.kind = kind
        super().__init__(cfg)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        return [self._FNS[self.kind](inputs[0])], state


class DropoutLayer(Layer):
    """Inverted dropout; identity at inference. Self-loop layer.

    The training forward keeps each element with probability ``pkeep =
    1 - threshold``: ``x * ((u < pkeep) / pkeep)``, the mask cast to
    x's dtype before the division, as the reference computes it."""

    self_loop = True
    needs_rng = True

    def __init__(self, cfg=()):
        self.threshold = 0.0
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "threshold":
            self.threshold = float(val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        if not (0.0 <= self.threshold < 1.0):
            raise ValueError("dropout: invalid threshold")
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False, rng=None):
        x = inputs[0]
        if not is_train or self.threshold == 0.0:
            return [x], state
        if rng is None:
            raise ValueError("dropout needs the step's rng in training")
        pkeep = 1.0 - self.threshold
        u = dropout_uniform(x.shape, rng, x.device)
        mask = (u < pkeep).to(x.dtype) / pkeep
        return [x * mask], state


class ConcatLayer(Layer):
    """n-to-1 concat. dim=3 ('concat') joins features (x); dim=1
    ('ch_concat') joins channels — reference NCHW dims."""

    def __init__(self, dim: int, cfg=()):
        self.dim = dim
        # (position, k, mode) when the net's pool_concat_pallas pass
        # fuses a pool branch into this concat (nnet/net.py)
        self.fused_pool = None
        super().__init__(cfg)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        if len(in_shapes) < 2:
            raise ValueError("concat: needs more than one input")
        base = in_shapes[0]
        total = 0
        for s in in_shapes:
            ref = (s.ch, s.y, s.x)
            b0 = (base.ch, base.y, base.x)
            for j, (a, b) in enumerate(zip(ref, b0)):
                if j + 1 != self.dim and a != b:
                    raise ValueError("concat: shape mismatch")
            total += ref[self.dim - 1]
        out = list(base)
        out[self.dim - 1] = total
        self.in_shapes = list(in_shapes)
        self.out_shapes = [Shape3(*out)]
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        if inputs[0].dim() == 2:
            if self.dim != 3:
                raise ValueError("ch_concat on matrix nodes is unsupported")
            return [torch.cat(inputs, dim=1)], state
        if self.fused_pool is not None and self.dim == 1:
            # the pool branch arrives UN-pooled; the pool_concat kernel
            # reduces its window while it writes every branch's segment
            pos, k, mode = self.fused_pool
            return [pool_concat(inputs, pos, k, mode)], state
        axis = {1: 3, 2: 1, 3: 2}[self.dim]   # NCHW dim -> NHWC axis
        return [torch.cat(inputs, dim=axis)], state


class SplitLayer(Layer):
    """1-to-n duplicate."""

    def __init__(self, n_out: int = 2, cfg=()):
        self.n_out = n_out
        super().__init__(cfg)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [s] * self.n_out
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        return [inputs[0]] * self.n_out, state
