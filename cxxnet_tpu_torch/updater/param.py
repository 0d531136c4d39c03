"""Updater hyper-parameters: LR/momentum schedules and tag-scoped
config (a copy of ``cxxnet_tpu/updater/param.py``; the port imports
nothing of the JAX package).

- four LR schedules: constant / expdecay / polydecay / factor, selected
  by ``lr:schedule``; ``lr:step``, ``lr:gamma``, ``lr:alpha``,
  ``lr:factor``, ``lr:minimum_lr``, ``lr:start_epoch``
- tag-scoped params: with tag 'wmat', a config key ``wmat:lr`` applies,
  while ``bias:lr`` is ignored
- momentum saturation schedule: a linear ramp base -> final over
  ``saturation_epoch``, clamped
- when ``epoch < start_epoch`` the LR is ``base_lr`` (the reset comes
  after the minimum clamp)
- layer-group LR scaling: ``lr_mult`` (and the ``wmult`` / ``bmult``
  aliases of the ``wmat`` / ``bias`` tags) multiplies the scheduled LR
  last; ``lr_mult = 0`` freezes the group
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..utils.config import NotPortedError, Roadmap


@dataclass
class UpdaterParam:
    tag: str = ""
    learning_rate: float = 0.01
    wd: float = 0.0
    momentum: float = 0.9
    lr_schedule: int = 0
    momentum_schedule: int = 0
    base_lr: float = 0.01
    lr_step: int = 1
    lr_gamma: float = 0.5
    lr_alpha: float = 0.5
    lr_factor: float = 0.1
    lr_minimum: float = 0.00001
    start_epoch: int = 0
    base_momentum: float = 0.5
    final_momentum: float = 0.90
    saturation_epoch: int = 0
    clip_gradient: float = 0.0
    # per-group LR multiplier (lr_mult / wmult / bmult): applied after
    # the schedule, 0 freezes the group (finetune layer groups)
    lr_mult: float = 1.0
    silent: int = 0
    # adam extras (adam_updater-inl.hpp:24-26: decay = 1 - beta)
    decay1: float = 0.1
    decay2: float = 0.001
    # storage dtype of the sgd/nag momentum buffer: only float32 is
    # ported (bfloat16 raises)
    momentum_dtype: str = "float32"

    @property
    def frozen(self) -> bool:
        """``lr_mult = 0`` pins the group's weights bit-exactly: sgd/nag
        allocate no momentum buffer and the trainer passes the weight
        through untouched. Adam's LR derives from base_lr inside its
        rule, so the skip applies only to the momentum updaters."""
        return self.lr_mult == 0.0

    def schedule_epoch(self, epoch: int) -> None:
        if self.lr_schedule == 0:
            lr = self.base_lr
        elif self.lr_schedule == 1:
            lr = self.base_lr * math.pow(self.lr_gamma,
                                         float(epoch) / self.lr_step)
        elif self.lr_schedule == 2:
            lr = self.base_lr * math.pow(
                1.0 + (epoch // self.lr_step) * self.lr_gamma,
                -self.lr_alpha)
        elif self.lr_schedule == 3:
            lr = self.base_lr * math.pow(self.lr_factor,
                                         epoch // self.lr_step)
        else:
            raise ValueError("unknown lr schedule type")
        if self.momentum_schedule and self.saturation_epoch:
            ramp = (self.base_momentum
                    + (self.final_momentum - self.base_momentum)
                    * epoch / self.saturation_epoch)
            self.momentum = min(ramp, self.final_momentum)
        self.learning_rate = max(lr, self.lr_minimum)
        if epoch < self.start_epoch:
            self.learning_rate = self.base_lr
        # group multiplier LAST so it composes with every schedule
        # (and lr_mult = 0 wins over the minimum-LR clamp: a frozen
        # group must see exactly 0, not lr_minimum)
        self.learning_rate *= self.lr_mult

    def set_param(self, name: str, val: str) -> None:
        # reference-style group multipliers BEFORE the tag strip: they
        # carry their tag in the key itself (wmult = wmat, bmult = bias)
        if name == "wmult" and self.tag == "wmat":
            self.lr_mult = float(val)
        if name == "bmult" and self.tag == "bias":
            self.lr_mult = float(val)
        # tag prefix strip: "wmat:lr" with tag=="wmat" -> "lr"
        if self.tag and name.startswith(self.tag):
            rest = name[len(self.tag):]
            if rest.startswith(":"):
                name = rest[1:]
        if name == "lr_mult":
            self.lr_mult = float(val)
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        if name == "wd":
            self.wd = float(val)
        if name == "momentum":
            self.momentum = float(val)
        if name == "silent":
            self.silent = int(val)
        if name == "momentum_schedule":
            self.momentum_schedule = int(val)
        if name == "clip_gradient":
            self.clip_gradient = float(val)
        if name == "momentum_dtype":
            if val not in ("float32", "bfloat16"):
                raise ValueError(
                    "momentum_dtype must be float32 or bfloat16")
            if val == "bfloat16":
                raise NotPortedError("momentum_dtype = bfloat16",
                                     Roadmap.LOW_PRECISION_TRAINING)
            self.momentum_dtype = val
        if name == "final_momentum":
            self.final_momentum = float(val)
        if name == "base_momentum":
            self.base_momentum = float(val)
        if name == "saturation_epoch":
            self.saturation_epoch = int(val)
        if name == "beta1":
            self.decay1 = float(val)
        if name == "beta2":
            self.decay2 = float(val)
        if name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                sched = {"constant": 0, "expdecay": 1,
                         "polydecay": 2, "factor": 3}
                if val in sched:
                    self.lr_schedule = sched[val]
            if sub == "gamma":
                self.lr_gamma = float(val)
            if sub == "alpha":
                self.lr_alpha = float(val)
            if sub == "step":
                self.lr_step = int(val)
            if sub == "factor":
                self.lr_factor = float(val)
            if sub == "minimum_lr":
                self.lr_minimum = float(val)
            if sub == "start_epoch":
                self.start_epoch = int(val)
