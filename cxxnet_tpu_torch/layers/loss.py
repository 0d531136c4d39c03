"""Loss layers (counterpart of ``cxxnet_tpu/layers/loss.py``).

A loss layer is a self-loop layer with two faces:

- ``forward``: the prediction transform (softmax probabilities,
  identity for ``lp_loss`` / ``l2_loss``, elementwise sigmoid for
  ``multi_logistic``) that predict and extract observe;
- ``loss_value``: a scalar whose gradient with respect to the
  *pre-transform* input is the reference gradient, scaled by
  ``grad_scale / batch_size`` (the trainer divides by
  ``update_period`` when an accumulation window closes).

``target`` binds the loss to a named label field (``label_vec``
ranges).
"""

from __future__ import annotations

from typing import List, Optional

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

    def _scale(self) -> float:
        if self.batch_size <= 0:
            raise ValueError("loss layer: batch_size not set")
        return self.grad_scale / self.batch_size

    def loss_value(self, logit: torch.Tensor, label: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Scalar loss; ``mask`` is 1.0 for real rows and 0.0 for tail
        padding, or None when every row is real."""
        raise NotImplementedError


class SoftmaxLayer(LossLayer):
    """Softmax + cross-entropy on an integer class label (1 column), in
    float32 (float64 stays float64)."""

    def forward(self, params, state, inputs, is_train=False):
        return [torch.softmax(inputs[0].float(), dim=-1)], state

    def loss_value(self, logit, label, mask):
        lab = label[:, 0].long()
        logp = torch.log_softmax(
            logit.to(torch.promote_types(logit.dtype, torch.float32)),
            dim=-1)
        ce = -logp.gather(1, lab[:, None])[:, 0]
        if mask is not None:
            ce = ce * mask
        return self._scale() * ce.sum()


class LpLossLayer(LossLayer):
    """Lp regression loss against a dense label block (``lp_loss``,
    ``l2_loss``; p default 2): ``scale * sum |x - label|^p``, whose
    gradient is the reference's ``p * |x - l|^(p-1) * sign(x - l) *
    scale``."""

    def __init__(self, cfg=()):
        self.p = 2.0
        super().__init__(cfg)

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == "p":
            self.p = float(val)

    def forward(self, params, state, inputs, is_train=False):
        return [inputs[0].float()], state

    def loss_value(self, logit, label, mask):
        d = torch.abs(logit.float() - label)
        if self.p == 2.0:
            lp = d * d
        elif self.p == 1.0:
            lp = d
        else:
            lp = torch.pow(d, self.p)
        row = lp.sum(-1)
        if mask is not None:
            row = row * mask
        return self._scale() * row.sum()


class MultiLogisticLayer(LossLayer):
    """Elementwise sigmoid + binary cross-entropy per output
    (``multi_logistic``, multi-label); the gradient is the reference's
    ``sigmoid(x) - label``."""

    def forward(self, params, state, inputs, is_train=False):
        return [torch.sigmoid(inputs[0].float())], state

    def loss_value(self, logit, label, mask):
        logit = logit.float()
        # BCE with logits, in the reference's stable form; maximum splits
        # the gradient at 0 as jnp.maximum does
        bce = torch.maximum(logit, torch.zeros_like(logit)) \
            - logit * label + torch.log1p(torch.exp(-torch.abs(logit)))
        row = bce.sum(-1)
        if mask is not None:
            row = row * mask
        return self._scale() * row.sum()
