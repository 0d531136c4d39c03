"""Pairwise layer testing: ``pairtest-<master>-<slave>`` (counterpart of
``cxxnet_tpu/layers/pairtest.py``).

One connection runs a *master* and a *slave* implementation of the same
layer on the same inputs. The master's output flows on; the slave is
tied in as ``m + s - s.detach()``, so autograd routes the same output
gradient to both sides, and the largest forward difference seen so far
is kept in the layer's state under ``pairtest:max_diff`` (it crosses
snapshots like any state). Both sides start from the same generator
state, so they start from the same weights wherever their parameters
have the same shapes, and both get the same step key.

Config keys ``master:xxx`` and ``slave:xxx`` go to one side; every
other key to both. The slave's params and state carry the prefix
``slave:``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .base import Layer, Shape3


class PairTestLayer(Layer):
    """Runs master + slave implementations side by side."""

    def __init__(self, master: Layer, slave: Layer,
                 cfg: Sequence[Tuple[str, str]] = ()) -> None:
        self.master = master
        self.slave = slave
        super().__init__(cfg)
        # the net treats a pairtested loss or self-loop layer as such
        self.is_loss = master.is_loss
        self.self_loop = master.self_loop

    def set_param(self, name: str, val: str) -> None:
        if name.startswith("master:"):
            self.master.set_param(name[len("master:"):], val)
        elif name.startswith("slave:"):
            self.slave.set_param(name[len("slave:"):], val)
        else:
            self.master.set_param(name, val)
            self.slave.set_param(name, val)

    def infer_shape(self, in_shapes: List[Shape3]) -> List[Shape3]:
        mo = self.master.infer_shape(list(in_shapes))
        so = self.slave.infer_shape(list(in_shapes))
        if mo != so:
            raise ValueError(
                "pairtest: master/slave output shapes disagree: %s vs %s"
                % (mo, so))
        self.in_shapes = list(in_shapes)
        self.out_shapes = mo
        return mo

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        # the same generator state on both sides
        start = gen.get_state()
        p = dict(self.master.init_params(gen))
        gen.set_state(start)
        for tag, v in self.slave.init_params(gen).items():
            p["slave:" + tag] = v
        return p

    def init_state(self) -> Dict[str, torch.Tensor]:
        s = dict(self.master.init_state())
        for tag, v in self.slave.init_state().items():
            s["slave:" + tag] = v
        s["pairtest:max_diff"] = torch.tensor(0.0, dtype=torch.float32)
        return s

    @staticmethod
    def _split(d: Dict[str, torch.Tensor]):
        m = {k: v for k, v in d.items()
             if not k.startswith(("slave:", "pairtest:"))}
        s = {k[len("slave:"):]: v for k, v in d.items()
             if k.startswith("slave:")}
        return m, s

    @property
    def needs_mask(self):
        return self.master.needs_mask or self.slave.needs_mask

    @property
    def needs_rng(self):
        return self.master.needs_rng or self.slave.needs_rng

    def forward(self, params, state, inputs, is_train=False, mask=None,
                rng=None):
        mp, sp = self._split(params)
        ms, ss = self._split(state)

        def run(layer, p, s):
            kw = {}
            if layer.needs_mask:
                kw["mask"] = mask
            if layer.needs_rng:
                kw["rng"] = rng
            return layer.forward(p, s, list(inputs), is_train, **kw)

        mouts, ms2 = run(self.master, mp, ms)
        souts, ss2 = run(self.slave, sp, ss)
        diff = torch.zeros((), dtype=torch.float32,
                           device=mouts[0].device)
        outs = []
        for m, s in zip(mouts, souts):
            with torch.no_grad():
                diff = torch.maximum(diff, (m - s).abs().max().float())
            # the master's value; the same gradient to both sides
            outs.append(m + s - s.detach())
        new_state = dict(ms2 or ms)
        for tag, v in (ss2 or ss).items():
            new_state["slave:" + tag] = v
        prev = state.get("pairtest:max_diff")
        new_state["pairtest:max_diff"] = diff if prev is None \
            else torch.maximum(prev, diff)
        return outs, new_state

    # the loss-layer protocol passes through (a pairtested loss layer)

    @property
    def target(self):
        return self.master.target

    @property
    def batch_size(self):
        return self.master.batch_size

    @batch_size.setter
    def batch_size(self, v):
        self.master.batch_size = v
        self.slave.batch_size = v

    def loss_value(self, logit, labels, mask):
        return self.master.loss_value(logit, labels, mask)
