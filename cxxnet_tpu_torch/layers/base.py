"""Layer base types (counterpart of ``cxxnet_tpu/layers/base.py``).

Layers are plain objects over dictionaries of tensors: a declarative
spec, shape inference, parameter init and a forward that serves both
evaluation and training (``is_train``; autograd differentiates the
training forward, in place of the reference's ``jax.grad``). The public
layouts are the reference's: spatial nodes are NHWC ``(batch, y, x,
ch)``, flattened nodes 2-D ``(batch, features)``, and logical node
shapes keep the ``(ch, y, x)`` convention (``Shape3``), where ch == 1
and y == 1 marks a "matrix" node stored 2-D.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import NotPortedError, Roadmap


class Shape3(NamedTuple):
    """Logical node shape without batch: (ch, y, x)."""
    ch: int
    y: int
    x: int

    @property
    def is_mat(self) -> bool:
        return self.ch == 1 and self.y == 1

    @property
    def flat_size(self) -> int:
        return self.ch * self.y * self.x


class StepKey(NamedTuple):
    """The randomness of one layer in one training step: the trainer's
    ``seed``, the global sample step and the layer's connection index.
    The reference draws from ``fold_in(fold_in(PRNGKey(seed + 1),
    step), layer)``; the port seeds a ``torch.Generator`` from the same
    triple, so the same triple gives the same draw on one device (the
    two frameworks' bits differ)."""
    seed: int
    step: int
    layer: int

    def generator_seed(self) -> int:
        """A 64-bit seed mixing the triple (splitmix64 per field)."""
        mask = (1 << 64) - 1
        h = 0
        for v in (self.seed + 1, self.step, self.layer):
            h = (h ^ (v & mask)) + 0x9E3779B97F4A7C15 & mask
            h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & mask
            h = (h ^ (h >> 27)) * 0x94D049BB133111EB & mask
            h ^= h >> 31
        return h


def array_shape(batch: int, s: Shape3) -> Tuple[int, ...]:
    """Concrete tensor shape for a logical node shape."""
    if s.is_mat:
        return (batch, s.x)
    return (batch, s.y, s.x, s.ch)


def as_mat(x: torch.Tensor) -> torch.Tensor:
    """View a node value as (batch, features) in the reference's NCHW
    c-order (ch major, then y, then x), from an NHWC tensor — the order
    the fullc weights after a flatten are laid out in."""
    if x.dim() == 2:
        return x
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


@dataclass
class LayerParam:
    """Common layer hyper-parameters (reference param.h:15-139)."""
    num_hidden: int = 0
    init_sigma: float = 0.01
    init_uniform: float = -1.0
    init_sparse: int = 10
    init_bias: float = 0.0
    num_channel: int = 0
    random_type: int = 0        # 0 gaussian, 1 uniform/xavier, 2 kaiming
    num_group: int = 1
    kernel_height: int = 0
    kernel_width: int = 0
    stride: int = 1
    pad_y: int = 0
    pad_x: int = 0
    no_bias: int = 0
    silent: int = 0
    num_input_channel: int = 0
    num_input_node: int = 0
    # run the conv's per-channel BN-fold epilogue (scale/shift + relu)
    # as one pass of the conv_epilogue kernel on the conv output,
    # instead of folding the scale into the weights
    conv_pallas_epilogue: int = 0
    # route relu_max_pooling through the relu_max_pool kernels where
    # their gate holds (stride-1 VALID square max pools)
    pallas_pool: int = 0
    # training batch norm folds normalize + affine into one per-channel
    # scale/shift (the default, as in the reference)
    bn_fold_affine: int = 1

    def set_param(self, name: str, val: str) -> None:
        if name == "init_sigma":
            self.init_sigma = float(val)
        if name == "init_uniform":
            self.init_uniform = float(val)
        if name == "init_bias":
            self.init_bias = float(val)
        if name == "init_sparse":
            self.init_sparse = int(val)
        if name == "random_type":
            if val == "gaussian":
                self.random_type = 0
            elif val in ("uniform", "xavier"):
                self.random_type = 1
            elif val == "kaiming":
                self.random_type = 2
            else:
                raise ValueError("invalid random_type %r" % val)
        if name == "nhidden":
            self.num_hidden = int(val)
        if name == "nchannel":
            self.num_channel = int(val)
        if name == "ngroup":
            self.num_group = int(val)
        if name == "kernel_size":
            self.kernel_width = self.kernel_height = int(val)
        if name == "kernel_height":
            self.kernel_height = int(val)
        if name == "kernel_width":
            self.kernel_width = int(val)
        if name == "stride":
            self.stride = int(val)
        if name == "pad":
            self.pad_y = self.pad_x = int(val)
        if name == "pad_y":
            self.pad_y = int(val)
        if name == "pad_x":
            self.pad_x = int(val)
        if name == "no_bias":
            self.no_bias = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "dtype":
            if val not in ("float32", "bfloat16"):
                raise ValueError("dtype must be float32 or bfloat16")
            if val == "bfloat16":
                raise NotPortedError("dtype = bfloat16", Roadmap.QUANTIZED)
        if name == "pallas_pool":
            self.pallas_pool = int(val)
        if name == "conv_pallas_epilogue":
            self.conv_pallas_epilogue = int(val)
        if name == "bn_fold_affine":
            self.bn_fold_affine = int(val)

    def rand_init_weight(self, gen: torch.Generator,
                         shape: Tuple[int, ...], in_num: int,
                         out_num: int) -> torch.Tensor:
        """Weight init families of reference RandInitWeight
        (param.h:113-138), drawn from ``gen`` on the CPU."""
        if self.random_type == 0:
            return self.init_sigma * torch.randn(shape, generator=gen)
        if self.random_type == 1:
            a = float(np.sqrt(3.0 / (in_num + out_num)))
            if self.init_uniform > 0:
                a = self.init_uniform
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * a
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = float(np.sqrt(2.0 / self.num_hidden))
            else:
                sigma = float(np.sqrt(
                    2.0 / (self.num_channel * self.kernel_width
                           * self.kernel_height)))
            return sigma * torch.randn(shape, generator=gen)
        raise ValueError("unsupported random_type %d" % self.random_type)


class Layer:
    """Base class: a declarative spec + a forward.

    Lifecycle: construct with merged config -> ``infer_shape`` (records
    input shapes, returns output shapes; raises on inconsistency) ->
    ``init_params`` / ``init_state`` -> ``forward``.
    """

    is_loss = False
    self_loop = False           # must be a self-loop connection

    def __init__(self, cfg: Sequence[Tuple[str, str]] = ()) -> None:
        self.param = LayerParam()
        self.in_shapes: List[Shape3] = []
        self.out_shapes: List[Shape3] = []
        for name, val in cfg:
            self.set_param(name, val)

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        raise NotImplementedError

    def _expect_one(self, in_shapes: List[Shape3]) -> Shape3:
        if len(in_shapes) != 1:
            raise ValueError("%s: only supports 1-1 connection"
                             % type(self).__name__)
        return in_shapes[0]

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Learnable parameters; keys 'wmat'/'bias' as in the reference
        (and in snapshots)."""
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Non-learnable persistent state (BN running stats)."""
        return {}

    #: layers that reduce over the batch dimension (batch norm) set this
    #: so the net passes them the padded-row mask as a keyword
    needs_mask = False
    #: stochastic layers (dropout) set this so the net passes them their
    #: :class:`StepKey` as the keyword ``rng`` in a training forward
    needs_rng = False

    def forward(self, params: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor],
                inputs: List[torch.Tensor], is_train: bool = False
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """Output tensors (one per output node) and the layer's state
        after the call (changed only by a training forward)."""
        raise NotImplementedError
