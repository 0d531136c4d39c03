"""Optimizers ("updaters") as per-tensor update rules (counterpart of
``cxxnet_tpu/updater/__init__.py``).

Each updater maps ``(w, grad, state, hyper) -> (w', state')`` for one
weight tensor, with one :class:`UpdaterParam` per (layer, tag) so
tag-scoped config (``wmat:lr``, ``bias:wd``) and per-layer overrides
resolve as in the reference. The rules are written out by hand:
``torch.optim`` implements none of them as the reference does.

- SGD: NaN-zeroing clip, momentum buffer, weight decay inside the
  momentum term. ``momentum_dtype = bfloat16`` stores the sgd/nag
  buffer in bf16; the update arithmetic stays f32 on the upcast buffer
  and the new buffer is rounded back (to nearest even).
- NAG: ``w += (1+mu)*m - mu*m_old``.
- Adam: the reference's parameterization (decay = 1 - beta), bias
  correction with the integer ``epoch + 1``, and the reference's
  weight-decay sign (``grad -= wd*w``).

The schedule (LR / momentum as a function of the update counter) is
evaluated on the host per step and enters as float32 scalars, as the
reference's packed float32 hyper array does. The rules allocate new
tensors (no in-place update): the optimizer state of Inception-BN is
one copy of its 11 M weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .param import UpdaterParam

Hyper = Dict[str, float]   # learning_rate, momentum, wd, epoch
State = Dict[str, torch.Tensor]


def _momentum_zeros(w: torch.Tensor, param: UpdaterParam) -> torch.Tensor:
    """The momentum buffer in its storage dtype: bf16 for a float32
    weight under ``momentum_dtype = bfloat16``, else w's dtype."""
    if param.momentum_dtype == "bfloat16" and w.dtype == torch.float32:
        return torch.zeros_like(w, dtype=torch.bfloat16)
    return torch.zeros_like(w)


def _clip_nan(g: torch.Tensor, bound: float) -> torch.Tensor:
    """NaN -> 0, then clamp to [-bound, bound]."""
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    return torch.clamp(g, -bound, bound)


class SGDUpdater:
    name = "sgd"

    def __init__(self, param: UpdaterParam):
        self.param = param

    def init_state(self, w: torch.Tensor) -> State:
        if self.param.frozen:
            return {}           # lr_mult=0: no momentum, no state bytes
        return {"m_w": _momentum_zeros(w, self.param)}

    def apply(self, w: torch.Tensor, g: torch.Tensor, state: State,
              hyper: Hyper) -> Tuple[torch.Tensor, State]:
        p = self.param
        if p.clip_gradient != 0.0:
            g = _clip_nan(g, p.clip_gradient)
        m_w = state["m_w"].to(w.dtype) * hyper["momentum"] \
            - hyper["learning_rate"] * (g + hyper["wd"] * w)
        return w + m_w, {"m_w": m_w.to(state["m_w"].dtype)}


class NAGUpdater:
    name = "nag"

    def __init__(self, param: UpdaterParam):
        self.param = param

    def init_state(self, w: torch.Tensor) -> State:
        if self.param.frozen:
            return {}
        return {"m_w": _momentum_zeros(w, self.param)}

    def apply(self, w, g, state, hyper):
        p = self.param
        if p.clip_gradient != 0.0:
            g = _clip_nan(g, p.clip_gradient)
        old = state["m_w"].to(w.dtype)
        m_w = old * hyper["momentum"] \
            - hyper["learning_rate"] * (g + hyper["wd"] * w)
        w = w + (1.0 + hyper["momentum"]) * m_w - hyper["momentum"] * old
        return w, {"m_w": m_w.to(state["m_w"].dtype)}


class AdamUpdater:
    name = "adam"

    def __init__(self, param: UpdaterParam):
        self.param = param

    def init_state(self, w: torch.Tensor) -> State:
        return {"m_w1": torch.zeros_like(w), "m_w2": torch.zeros_like(w)}

    def apply(self, w, g, state, hyper):
        p = self.param
        if p.clip_gradient != 0.0:
            g = _clip_nan(g, p.clip_gradient)
        if p.wd > 0.0:
            g = g - p.wd * w        # the reference's sign
        # the epoch is an exact integer; + 1 before the float32
        # conversion the power needs, as the reference's uint32 epoch
        t = np.float32(int(hyper["epoch"]) + 1)
        fix1 = np.float32(1.0) - np.power(np.float32(1.0 - p.decay1), t)
        fix2 = np.float32(1.0) - np.power(np.float32(1.0 - p.decay2), t)
        lr_t = float(np.float32(p.base_lr) * np.sqrt(fix2) / fix1)
        m1 = state["m_w1"] + p.decay1 * (g - state["m_w1"])
        m2 = state["m_w2"] + p.decay2 * (g * g - state["m_w2"])
        w = w - lr_t * (m1 / (torch.sqrt(m2) + 1e-8))
        return w, {"m_w1": m1, "m_w2": m2}


_UPDATERS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater}


def create_updater(type_str: str, tag: str, defcfg=(), layercfg=()):
    """Build an updater for one weight tensor: global defaults first,
    then the owning layer's local config, both tag-scoped."""
    if type_str not in _UPDATERS:
        raise ValueError("unknown updater type %r" % type_str)
    param = UpdaterParam(tag=tag)
    for name, val in list(defcfg) + list(layercfg):
        param.set_param(name, val)
    return _UPDATERS[type_str](param)


__all__ = ["UpdaterParam", "SGDUpdater", "NAGUpdater", "AdamUpdater",
           "create_updater"]
