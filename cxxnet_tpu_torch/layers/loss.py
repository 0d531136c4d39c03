"""Loss layers (counterpart of ``cxxnet_tpu/layers/loss.py``), eval
forwards only: the prediction transform that predict and extract
observe. The training losses come with the training slice."""

from __future__ import annotations

from typing import List

import torch

from .base import Layer, Shape3


class LossLayer(Layer):
    is_loss = True
    self_loop = True

    def __init__(self, cfg=()):
        self.target = "label"
        self.grad_scale = 1.0
        self.batch_size = 0          # global batch size, set by the net
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "target":
            self.target = val
        if name == "grad_scale":
            self.grad_scale = float(val)
        if name == "batch_size":
            self.batch_size = int(val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        self.in_shapes = [s]
        self.out_shapes = [s]
        return self.out_shapes


class SoftmaxLayer(LossLayer):
    """Softmax over the class axis, in float32."""

    def forward(self, params, state, inputs):
        return [torch.softmax(inputs[0].float(), dim=-1)]
