"""The ``torch`` layer type (counterpart of
``cxxnet_tpu/layers/torch_adapter.py``): the reference's in-net
foreign-framework oracle, a fullc or conv computed by PyTorch on the
host. In the port the whole net is PyTorch, so it is a plain
``F.linear`` or ``F.conv2d`` on the layer's own device, with the
reference's parameter layouts (fullc ``wmat`` (in, out), conv ``wmat``
HWIO, ``bias``) and the same init as the native layers, so that
``pairtest-conv-torch`` and ``pairtest-fullc-torch`` start from one set
of weights. The op comes from ``op``, else from ``nchannel`` (conv) or
``nhidden`` (fullc). It computes in float32 whatever the config's
``dtype``, as the reference's host callback does.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .base import Layer, Shape3
from .common import FullConnectLayer
from .conv import ConvolutionLayer, _conv_out_dim


class TorchLayer(Layer):
    """The ``torch`` config layer: a PyTorch fullc or conv."""

    def __init__(self, cfg=()):
        self.op = ""            # "" = infer from config keys
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "op":
            self.op = val

    def _resolve_op(self) -> str:
        if self.op:
            return self.op
        if self.param.num_channel > 0:
            return "conv"
        if self.param.num_hidden > 0:
            return "fullc"
        raise ValueError(
            "torch layer: set nhidden (linear) or nchannel (conv)")

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        s = self._expect_one(in_shapes)
        p = self.param
        op = self._resolve_op()
        self.in_shapes = [s]
        if op == "fullc":
            if not s.is_mat:
                raise ValueError("torch fullc: input must be a matrix")
            if p.num_input_node == 0:
                p.num_input_node = s.x
            self.out_shapes = [Shape3(1, 1, p.num_hidden)]
        else:
            if p.pad_y != p.pad_x:
                raise ValueError("torch conv: asymmetric pad unsupported")
            if p.num_input_channel == 0:
                p.num_input_channel = s.ch
            oy = _conv_out_dim(s.y, p.pad_y, p.kernel_height, p.stride)
            ox = _conv_out_dim(s.x, p.pad_x, p.kernel_width, p.stride)
            self.out_shapes = [Shape3(p.num_channel, oy, ox)]
        return self.out_shapes

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        # the native layers' layouts and draws (they read only self.param)
        native = FullConnectLayer if self._resolve_op() == "fullc" \
            else ConvolutionLayer
        return native.init_params(self, gen)

    def forward(self, params, state, inputs, is_train=False):
        p = self.param
        x = inputs[0].float()
        w = params["wmat"].float()
        b = params.get("bias")
        if b is not None:
            b = b.float()
        if self._resolve_op() == "fullc":
            return [F.linear(x, w.t(), b)], state
        # NHWC -> NCHW and HWIO -> OIHW views, as the reference's callback
        y = F.conv2d(x.contiguous().permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     b, stride=p.stride, padding=p.pad_y, groups=p.num_group)
        return [y.permute(0, 2, 3, 1)], state
