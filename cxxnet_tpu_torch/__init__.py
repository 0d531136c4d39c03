"""cxxnet_tpu_torch: the cxxnet rebuild in PyTorch for one NVIDIA Hopper GPU.

A second package beside the JAX reference (``cxxnet_tpu``). It keeps the
reference's config grammar, snapshot format and public layouts (NHWC
activations, HWIO conv weights, ``(in, out)`` fullc weights) and
replaces each TPU Pallas kernel on its path with a kernel written by
hand for ``sm_90a`` (``csrc/``).

What is ported so far: the serving path (``serve.ServeSession`` over a
snapshot, through ``nnet.trainer.NetTrainer`` and ``nnet.net.FuncNet``,
with the ``conv_epilogue`` kernel) and the training path
(``NetTrainer.update`` / ``run_steps`` / ``update_many``, autograd over
``FuncNet.loss_fn``, the ``updater`` rules, with the ``bn_apply`` and
``matmul`` kernels, and for kaiming's fused pools the ``relu_max_pool``
kernels, with dropout), the CLI (``python -m cxxnet_tpu_torch.main``)
over the ported iterators, and every layer type of the reference
(``layers.known_layer_type``). Config keys whose feature is not ported
raise :class:`~cxxnet_tpu_torch.utils.config.NotPortedError`.

Importing this package imports no JAX, builds no kernel and touches no
device.
"""

__all__ = ["graph", "io", "layers", "models", "nnet", "serve", "updater",
           "utils"]
