"""Dense / elementwise / structural layers (counterpart of
``cxxnet_tpu/layers/common.py``); one forward for evaluation and
training, differentiated by autograd:

- fullc        — y = x @ W + b, W stored (in, out); at eval under
  ``serve_dtype = int8`` an int8 product into int32 (``fp8``: an e4m3
  product into float32), dequantized per out channel; under ``serve_dtype = bfloat16`` or ``dtype = bfloat16`` a
  product of bf16 operands (bf16 output)
- pallas_fullc — the same through the matmul kernel
  (``PallasFullConnectLayer``, counterpart of the reference's in
  ``pallas_kernels.py:543-559``), whose output is float32 also on bf16
  operands. A bias on a bf16 output adds through ``kernels.bias_add``,
  whose gradient sums in bf16 in the reference's order
- flatten      — NHWC -> (batch, ch*y*x) in the reference's NCHW order
- bias         — a learned bias added to a matrix node (self-loop)
- relu/sigmoid/tanh/softplus
- xelu         — ``x > 0 ? x : x / b`` (a division, not a product)
- insanity / rrelu — xelu with a divisor drawn from U[lb, ub] in
  training and (lb + ub) / 2 at inference, the bounds annealed in the
  layer's state between ``calm_start`` and ``calm_end``
- prelu        — a learned slope per channel (or feature), with training
  noise; its gradient is the reference's, which ignores the clamp and
  the noise
- dropout      — inverted dropout in training, identity at inference
  (self-loop)
- concat/ch_concat — under the net's ``pool_concat_pallas`` pass a
  ch_concat whose pool branch fused into it runs as the pool_concat
  kernel
- split
- fixconn      — a fixed (not learned) connection matrix read from a
  text file

Every training draw of the stochastic layers (dropout, insanity, prelu's
noise, and insanity pooling in ``conv.py``) comes from
:func:`dropout_uniform`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.stream import open_stream
from .base import Layer, Shape3, StepKey, as_mat
from .kernels import bias_add, matmul, pool_concat
from .quant_ops import dot_fp8, dot_int8


def dropout_uniform(shape: Sequence[int], key: StepKey,
                    device: torch.device) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of ``shape`` on ``device`` for one
    stochastic layer in one step (a dropout mask, an insanity divisor,
    prelu's noise, insanity pooling's displacement), from a
    ``torch.Generator`` on that device seeded by ``key``. The one place
    the layers' randomness comes from: a parity test replaces it to feed
    the reference's draws, which are ``uniform(key, shape)`` for every
    one of these layers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key.generator_seed())
    return torch.rand(tuple(shape), generator=gen, device=device)


class FullConnectLayer(Layer):
    """y = x @ W + b with W stored (in_features, num_hidden), the
    reference package's layout; the reference-convention transpose
    happens only at the weight get/set API (trainer.get_weight)."""

    remat_name = "dot"

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
        # (fp8) contracts the quantized operands into int32 (float32)
        # and dequantizes per out channel; bfloat16 multiplies bf16
        # operands
        q = None if is_train else self._quant
        if q is not None and q.is_affine:
            dq = params.get("_r_dequant")
            if dq is None:               # not frozen: quantize per call
                wq, dq = q.weight_operand(params["wmat"]), q.dequant_vec()
            else:
                wq = params["_wq"]
            xq = q.quantize_x(x)
            dot_q = dot_fp8 if q.dtype == "fp8" else dot_int8
            y = dot_q(xq, wq, self.param.num_hidden) if q.native \
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
    both backward products are kernel launches; the bias add is plain.
    Its product is a kernel launch, not a dot: ``remat = dots`` does
    not keep it (the reference's is a ``pallas_call``)."""

    remat_name = None

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


class BiasLayer(Layer):
    """Self-loop learned bias add on a matrix node."""

    self_loop = True

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        if not s.is_mat:
            raise ValueError("bias: only works on flattened nodes")
        if self.param.num_input_node == 0:
            self.param.num_input_node = s.x
        elif self.param.num_input_node != s.x:
            raise ValueError("bias: input hidden nodes not consistent")
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return {"bias": torch.full((self.param.num_input_node,),
                                   self.param.init_bias, dtype=torch.float32)}

    def forward(self, params, state, inputs, is_train=False):
        # a bf16 node promotes to float32, as in the reference
        return [inputs[0] + params["bias"]], state


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


def _xelu(x: torch.Tensor, b) -> torch.Tensor:
    """``x > 0 ? x : x / b``. A Python ``b`` rounds to x's dtype first
    (the reference's weakly typed constant); a tensor ``b`` (float32,
    of any shape) promotes a bf16 x to float32, as in the reference."""
    if isinstance(b, torch.Tensor):
        x = x.to(torch.promote_types(x.dtype, b.dtype))
    else:
        b = torch.tensor(b, dtype=x.dtype, device=x.device)
    return torch.where(x > 0, x, x / b)


class _OneOutput(Layer):
    """A 1-1 layer whose output node has its input's shape."""

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes


class XeluLayer(_OneOutput):
    """Leaky relu with divisor b (default 5)."""

    def __init__(self, cfg=()):
        self.b = 5.0
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "b":
            self.b = float(val)

    def forward(self, params, state, inputs, is_train=False):
        return [_xelu(inputs[0], self.b)], state


class InsanityLayer(_OneOutput):
    """Randomized leaky relu (``insanity`` / ``rrelu``): xelu whose
    divisor is drawn from U[lb, ub] per element in training and is
    (lb + ub) / 2 at inference. The bounds live in the layer's state
    (``lb``, ``ub``, and the int32 ``step``) and anneal as the
    reference's do: while ``calm_start < step < calm_end`` every forward
    moves them by ``delta * step`` (cumulative), delta from the initial
    bounds, and advances ``step``; outside that window nothing moves."""

    needs_rng = True

    def __init__(self, cfg=()):
        self.lb = 5.0
        self.ub = 10.0
        self.calm_start = 0
        self.calm_end = 0
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "lb":
            self.lb = float(val)
        if name == "ub":
            self.ub = float(val)
        if name == "calm_start":
            self.calm_start = int(val)
        if name == "calm_end":
            self.calm_end = int(val)

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {"lb": torch.tensor(self.lb, dtype=torch.float32),
                "ub": torch.tensor(self.ub, dtype=torch.float32),
                "step": torch.tensor(0, dtype=torch.int32)}

    def forward(self, params, state, inputs, is_train=False, rng=None):
        x = inputs[0]
        lb, ub, step = state["lb"], state["ub"], state["step"]
        if self.calm_end > self.calm_start:
            # delta from the initial bounds, rounded to float32
            delta = torch.tensor((self.ub - (self.ub + self.lb) / 2.0)
                                 / (self.calm_end - self.calm_start),
                                 dtype=torch.float32, device=lb.device)
            active = (step > self.calm_start) & (step < self.calm_end)
            ub = torch.where(active, ub - delta * step, ub)
            lb = torch.where(active, lb + delta * step, lb)
            step = torch.where(active, step + 1, step)
        if is_train:
            if rng is None:
                raise ValueError("insanity needs the step's rng in training")
            u = dropout_uniform(x.shape, rng, x.device)
            out = _xelu(x, u * (ub - lb) + lb)
        else:
            out = _xelu(x, (lb + ub) / 2.0)
        return [out], dict(state, lb=lb, ub=ub, step=step)


class _PRelu(torch.autograd.Function):
    """``x > 0 ? x : x * mask`` with the reference's hand VJP: dx passes
    dy where x > 0 and ``mask * dy`` elsewhere; the mask's gradient is
    ``dy * (x < 0 ? x : 0)``, which ignores the clamp and the noise that
    made the mask (the reference's gslope)."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(x, mask)
        return torch.where(x > 0, x, x * mask)

    @staticmethod
    def backward(ctx, dy):
        x, mask = ctx.saved_tensors
        dx = torch.where(x > 0, dy, mask * dy)
        dmask = torch.where(x < 0, x, 0.0) * dy
        return dx, dmask


class PReluLayer(_OneOutput):
    """Learned negative slope per channel (per feature on a matrix
    node), with training noise ``U[-random, random)`` on the slope; the
    slope is clamped to [0, 1]. The slope's tag is ``bias``, as in the
    reference, so ``bias:`` updater keys apply to it."""

    def __init__(self, cfg=()):
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0
        self.channel = 0
        super().__init__(cfg)

    @property
    def needs_rng(self):
        return self.random > 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "init_slope":
            self.init_slope = float(val)
        if name == "random_slope":
            self.init_random = int(val)
        if name == "random":
            self.random = float(val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.channel = s.x if s.is_mat else s.ch
        return super().infer_shape(in_shapes)

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        if self.init_random == 0:
            slope = torch.full((self.channel,), self.init_slope,
                               dtype=torch.float32)
        else:
            slope = torch.rand((self.channel,), generator=gen) \
                * self.init_slope
        return {"bias": slope}

    def forward(self, params, state, inputs, is_train=False, rng=None):
        x = inputs[0]
        mask = params["bias"].expand(x.shape)
        if is_train and self.random > 0:
            if rng is None:
                raise ValueError("prelu needs the step's rng in training")
            noise = dropout_uniform(x.shape, rng, x.device) \
                * self.random * 2.0 - self.random
            mask = mask * (1.0 + noise)
        # the clamp as maximum then minimum: a slope at 0 or 1 takes half
        # the gradient, as jnp.clip's does
        mask = torch.minimum(torch.maximum(mask, torch.zeros_like(mask)),
                             torch.ones_like(mask))
        return [_PRelu.apply(x, mask)], state


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


class FixConnectLayer(Layer):
    """A fixed (not learned) connection matrix from a text file
    (``fixconn_weight``, read through the port's streams): a header
    ``nrow ncol nnz`` then ``row col value`` triples of a (num_hidden,
    num_input) matrix in the reference's convention. It is held as an
    (in, out) tensor, like fullc's weight, and is no parameter."""

    remat_name = "dot"

    def __init__(self, cfg=()):
        self.fname_weight = ""
        self._w = None
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "fixconn_weight":
            self.fname_weight = val

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        if not s.is_mat:
            raise ValueError("fixconn: input must be a matrix")
        if self.param.num_hidden <= 0:
            raise ValueError("fixconn: must set nhidden correctly")
        if not self.fname_weight:
            raise ValueError("fixconn: must specify fixconn_weight")
        self.in_shapes = [s]
        self.out_shapes = [Shape3(1, 1, self.param.num_hidden)]
        w = np.zeros((self.param.num_hidden, s.x), np.float32)
        with open_stream(self.fname_weight, "r") as f:
            toks = f.read().split()
        nrow, ncol, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        if (nrow, ncol) != w.shape:
            raise ValueError("fixconn: weight shape does not match")
        vals = toks[3:3 + 3 * nnz]
        for t in range(nnz):
            r, c = int(vals[3 * t]), int(vals[3 * t + 1])
            w[r, c] = float(vals[3 * t + 2])
        self._w = torch.from_numpy(np.ascontiguousarray(w.T))
        return self.out_shapes

    def forward(self, params, state, inputs, is_train=False):
        x = inputs[0]
        if self._w.device != x.device:
            self._w = self._w.to(x.device)
        w = self._w
        # a bf16 x promotes to the float32 matrix, as in the reference
        wide = torch.promote_types(x.dtype, w.dtype)
        return [x.to(wide) @ w.to(wide)], state
