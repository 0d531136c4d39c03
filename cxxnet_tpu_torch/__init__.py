"""cxxnet_tpu_torch: the cxxnet rebuild in PyTorch for one NVIDIA Hopper GPU.

A second package beside the JAX reference (``cxxnet_tpu``). It keeps the
reference's config grammar, snapshot format and public layouts (NHWC
activations, HWIO conv weights, ``(in, out)`` fullc weights) and
replaces each TPU Pallas kernel on its path with a kernel written by
hand for ``sm_90a`` (``csrc/``).

What is ported so far is the serving path: ``serve.ServeSession`` over a
snapshot, through ``nnet.trainer.NetTrainer`` and ``nnet.net.FuncNet``,
with the ``conv_epilogue`` kernel. Config keys whose feature is not
ported raise :class:`~cxxnet_tpu_torch.utils.config.NotPortedError`.

Importing this package imports no JAX, builds no kernel and touches no
device.
"""

__all__ = ["graph", "layers", "models", "nnet", "serve", "utils"]
