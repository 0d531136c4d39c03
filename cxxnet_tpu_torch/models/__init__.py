"""Model zoo: programmatic builders for the netconfig DSL (the models
of the ported serving and training slices)."""

from .inception import inception_bn, inception_bn_tiny
from .kaiming import kaiming

__all__ = ["inception_bn", "inception_bn_tiny", "kaiming"]
