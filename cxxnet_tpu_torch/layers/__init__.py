"""Layer registry: string type -> layer factory (counterpart of
``cxxnet_tpu/layers/__init__.py``), restricted to the layer types the
ported serving and training slices run. Every other type the reference
knows raises :class:`NotPortedError` naming the ROADMAP item that ports
it; a type neither package knows raises ``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

from ..utils.config import NotPortedError, Roadmap
from .base import Layer, LayerParam, Shape3, array_shape, as_mat
from .common import (ActivationLayer, ConcatLayer, DropoutLayer,
                     FlattenLayer, FullConnectLayer, PallasFullConnectLayer,
                     SplitLayer)
from .conv import BatchNormLayer, ConvolutionLayer, PoolingLayer
from .loss import LossLayer, SoftmaxLayer

_FACTORY: Dict[str, Callable[..., Layer]] = {
    "fullc": lambda cfg, **kw: FullConnectLayer(cfg),
    "pallas_fullc": lambda cfg, **kw: PallasFullConnectLayer(cfg),
    "softmax": lambda cfg, **kw: SoftmaxLayer(cfg),
    "relu": lambda cfg, **kw: ActivationLayer("relu", cfg),
    "sigmoid": lambda cfg, **kw: ActivationLayer("sigmoid", cfg),
    "tanh": lambda cfg, **kw: ActivationLayer("tanh", cfg),
    "softplus": lambda cfg, **kw: ActivationLayer("softplus", cfg),
    "flatten": lambda cfg, **kw: FlattenLayer(cfg),
    "dropout": lambda cfg, **kw: DropoutLayer(cfg),
    "conv": lambda cfg, **kw: ConvolutionLayer(cfg),
    "max_pooling": lambda cfg, **kw: PoolingLayer("max", cfg),
    "avg_pooling": lambda cfg, **kw: PoolingLayer("avg", cfg),
    # relu fused before the pool; with pallas_pool = 1 (or as
    # pallas_relu_max_pooling) through the relu_max_pool kernels
    "relu_max_pooling": lambda cfg, **kw: PoolingLayer("max", cfg,
                                                       pre_relu=True),
    "pallas_relu_max_pooling": lambda cfg, **kw: PoolingLayer(
        "max", cfg, pre_relu=True, use_pallas=True),
    "concat": lambda cfg, **kw: ConcatLayer(3, cfg),
    "ch_concat": lambda cfg, **kw: ConcatLayer(1, cfg),
    "split": lambda cfg, n_out=2, **kw: SplitLayer(n_out, cfg),
    "batch_norm": lambda cfg, **kw: BatchNormLayer(cfg),
    # batch_norm with the folded epilogue through the bn_apply kernel
    "pallas_batch_norm": lambda cfg, **kw: BatchNormLayer(
        cfg, use_pallas=True),
}

# reference layer types not ported yet -> the ROADMAP item porting them
_NOT_PORTED = {t: Roadmap.LAYER_ZOO for t in (
    "insanity", "rrelu", "fixconn", "bias", "sum_pooling", "lrn", "xelu",
    "insanity_max_pooling", "lp_loss", "l2_loss", "multi_logistic", "prelu",
    "batch_norm_no_ma", "torch", "maxout")}


def create_layer(type_str: str, cfg: Sequence[Tuple[str, str]] = (),
                 **kwargs) -> Layer:
    """Create a layer from its config-file type string."""
    if type_str.startswith("pairtest-"):
        raise NotPortedError("layer type %r" % type_str, Roadmap.LAYER_ZOO)
    if type_str in _NOT_PORTED:
        raise NotPortedError("layer type %r" % type_str,
                             _NOT_PORTED[type_str])
    if type_str not in _FACTORY:
        raise ValueError("unknown layer type: %r" % type_str)
    return _FACTORY[type_str](list(cfg), **kwargs)


__all__ = ["Layer", "LayerParam", "Shape3", "array_shape", "as_mat",
           "create_layer", "LossLayer"]
