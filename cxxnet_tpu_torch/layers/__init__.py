"""Layer registry: string type -> layer factory (counterpart of
``cxxnet_tpu/layers/__init__.py``), with every layer type the reference
knows. ``maxout``, which the reference registers without an
implementation, raises its ``ValueError``, and so does a type neither
package knows.

``pairtest-A-B`` runs layer A (master) and layer B (slave) side by side
(``pairtest.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

from .base import Layer, LayerParam, Shape3, array_shape, as_mat
from .common import (ActivationLayer, BiasLayer, ConcatLayer, DropoutLayer,
                     FixConnectLayer, FlattenLayer, FullConnectLayer,
                     InsanityLayer, PallasFullConnectLayer, PReluLayer,
                     SplitLayer, XeluLayer)
from .conv import (BatchNormLayer, ConvolutionLayer, InsanityPoolingLayer,
                   LRNLayer, PoolingLayer)
from .loss import LossLayer, LpLossLayer, MultiLogisticLayer, SoftmaxLayer
from .pairtest import PairTestLayer
from .torch_adapter import TorchLayer

_FACTORY: Dict[str, Callable[..., Layer]] = {
    "fullc": lambda cfg, **kw: FullConnectLayer(cfg),
    "pallas_fullc": lambda cfg, **kw: PallasFullConnectLayer(cfg),
    "fixconn": lambda cfg, **kw: FixConnectLayer(cfg),
    "bias": lambda cfg, **kw: BiasLayer(cfg),
    "softmax": lambda cfg, **kw: SoftmaxLayer(cfg),
    "relu": lambda cfg, **kw: ActivationLayer("relu", cfg),
    "sigmoid": lambda cfg, **kw: ActivationLayer("sigmoid", cfg),
    "tanh": lambda cfg, **kw: ActivationLayer("tanh", cfg),
    "softplus": lambda cfg, **kw: ActivationLayer("softplus", cfg),
    "flatten": lambda cfg, **kw: FlattenLayer(cfg),
    "dropout": lambda cfg, **kw: DropoutLayer(cfg),
    "conv": lambda cfg, **kw: ConvolutionLayer(cfg),
    "max_pooling": lambda cfg, **kw: PoolingLayer("max", cfg),
    "sum_pooling": lambda cfg, **kw: PoolingLayer("sum", cfg),
    "avg_pooling": lambda cfg, **kw: PoolingLayer("avg", cfg),
    # relu fused before the pool; with pallas_pool = 1 (or as
    # pallas_relu_max_pooling) through the relu_max_pool kernels
    "relu_max_pooling": lambda cfg, **kw: PoolingLayer("max", cfg,
                                                       pre_relu=True),
    "pallas_relu_max_pooling": lambda cfg, **kw: PoolingLayer(
        "max", cfg, pre_relu=True, use_pallas=True),
    "lrn": lambda cfg, **kw: LRNLayer(cfg),
    "concat": lambda cfg, **kw: ConcatLayer(3, cfg),
    "ch_concat": lambda cfg, **kw: ConcatLayer(1, cfg),
    "xelu": lambda cfg, **kw: XeluLayer(cfg),
    "split": lambda cfg, n_out=2, **kw: SplitLayer(n_out, cfg),
    "insanity": lambda cfg, **kw: InsanityLayer(cfg),
    "rrelu": lambda cfg, **kw: InsanityLayer(cfg),
    "insanity_max_pooling": lambda cfg, **kw: InsanityPoolingLayer("max", cfg),
    "lp_loss": lambda cfg, **kw: LpLossLayer(cfg),
    "l2_loss": lambda cfg, **kw: LpLossLayer(cfg),
    "multi_logistic": lambda cfg, **kw: MultiLogisticLayer(cfg),
    "prelu": lambda cfg, **kw: PReluLayer(cfg),
    "batch_norm": lambda cfg, **kw: BatchNormLayer(cfg),
    "batch_norm_no_ma": lambda cfg, **kw: BatchNormLayer(cfg,
                                                         moving_avg=False),
    # batch_norm with the folded epilogue through the bn_apply kernel
    "pallas_batch_norm": lambda cfg, **kw: BatchNormLayer(
        cfg, use_pallas=True),
    # the reference's foreign-framework oracle: a PyTorch fullc or conv
    "torch": lambda cfg, **kw: TorchLayer(cfg),
}

# registered in the reference's enum but rejected by its factory
_VESTIGIAL = ("maxout",)


def known_layer_type(type_str: str) -> bool:
    if type_str.startswith("pairtest-"):
        a, _, b = type_str[len("pairtest-"):].partition("-")
        return known_layer_type(a) and known_layer_type(b)
    return type_str in _FACTORY or type_str in _VESTIGIAL


def create_layer(type_str: str, cfg: Sequence[Tuple[str, str]] = (),
                 **kwargs) -> Layer:
    """Create a layer from its config-file type string."""
    if type_str.startswith("pairtest-"):
        a, _, b = type_str[len("pairtest-"):].partition("-")
        if not a or not b:
            raise ValueError("pairtest type must be pairtest-<master>-<slave>")
        cfg = list(cfg)
        shared = [(n, v) for n, v in cfg
                  if not n.startswith(("master:", "slave:"))]
        master = create_layer(a, shared + [
            (n[len("master:"):], v) for n, v in cfg
            if n.startswith("master:")], **kwargs)
        slave = create_layer(b, shared + [
            (n[len("slave:"):], v) for n, v in cfg
            if n.startswith("slave:")], **kwargs)
        return PairTestLayer(master, slave)
    if type_str in _VESTIGIAL:
        raise ValueError(
            "layer type %r is registered but has no implementation "
            "(matches reference factory behavior)" % type_str)
    if type_str not in _FACTORY:
        raise ValueError("unknown layer type: %r" % type_str)
    return _FACTORY[type_str](list(cfg), **kwargs)


__all__ = ["Layer", "LayerParam", "Shape3", "array_shape", "as_mat",
           "create_layer", "known_layer_type", "LossLayer"]
