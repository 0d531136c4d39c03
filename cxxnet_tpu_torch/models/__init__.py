"""Model zoo: programmatic builders for the netconfig DSL (the models
of the ported serving slice)."""

from .inception import inception_bn, inception_bn_tiny

__all__ = ["inception_bn", "inception_bn_tiny"]
