"""Dense / elementwise / structural layers (counterpart of
``cxxnet_tpu/layers/common.py``), eval forwards only:

- fullc        — y = x @ W + b, W stored (in, out)
- flatten      — NHWC -> (batch, ch*y*x) in the reference's NCHW order
- relu/sigmoid/tanh/softplus
- dropout      — identity at inference (self-loop)
- concat/ch_concat
- split
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .base import Layer, Shape3, as_mat


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

    def forward(self, params, state, inputs):
        y = inputs[0] @ params["wmat"]
        if self.param.no_bias == 0:
            y = y + params["bias"]
        return [y]


class FlattenLayer(Layer):
    """Reshape (b,y,x,ch) -> (b, ch*y*x) in reference NCHW c-order."""

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [Shape3(1, 1, s.flat_size)]
        return self.out_shapes

    def forward(self, params, state, inputs):
        return [as_mat(inputs[0])]


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

    def forward(self, params, state, inputs):
        return [self._FNS[self.kind](inputs[0])]


class DropoutLayer(Layer):
    """Inverted dropout; identity at inference. Self-loop layer."""

    self_loop = True

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

    def forward(self, params, state, inputs):
        return [inputs[0]]


class ConcatLayer(Layer):
    """n-to-1 concat. dim=3 ('concat') joins features (x); dim=1
    ('ch_concat') joins channels — reference NCHW dims."""

    def __init__(self, dim: int, cfg=()):
        self.dim = dim
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

    def forward(self, params, state, inputs):
        if inputs[0].dim() == 2:
            if self.dim != 3:
                raise ValueError("ch_concat on matrix nodes is unsupported")
            return [torch.cat(inputs, dim=1)]
        axis = {1: 3, 2: 1, 3: 2}[self.dim]   # NCHW dim -> NHWC axis
        return [torch.cat(inputs, dim=axis)]


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

    def forward(self, params, state, inputs):
        return [inputs[0]] * self.n_out
