"""Model zoo: programmatic builders for the netconfig DSL (copies of
``cxxnet_tpu/models``). Each returns config text, so both packages
parse the same net from the same string."""

from .alexnet import alexnet
from .bowl import kaggle_bowl
from .inception import inception_bn, inception_bn_tiny
from .kaiming import kaiming
from .mnist import mnist_conv, mnist_mlp

__all__ = ["mnist_mlp", "mnist_conv", "alexnet", "inception_bn",
           "inception_bn_tiny", "kaggle_bowl", "kaiming"]
