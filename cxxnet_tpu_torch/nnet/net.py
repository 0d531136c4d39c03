"""The functional net: graph -> layer objects, shape inference and the
eval forward (counterpart of ``cxxnet_tpu/nnet/net.py``).

Net-level fusion passes of the reference that the serving path runs:

- ``bn_fuse_relu = 1``: a relu that is the sole consumer of a
  batch-norm output runs inside the BN layer; the relu connection
  becomes identity.
- ``bn_fold_eval = 1``: a moving-average batch_norm that solely
  consumes a conv's output folds its running-stats scale/shift into
  the conv (into the weight, or into the conv_epilogue kernel under
  ``conv_pallas_epilogue = 1``); the BN connection becomes identity.

Both change what interior nodes hold (the BN output node carries the
post-relu value; the conv output node the folded conv+BN value), as in
the reference. ``pool_concat_pallas`` and ``channel_pad`` are not
ported and raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..graph import NetGraph
from ..layers import Layer, Shape3, create_layer
from ..utils.config import NotPortedError, Roadmap

Params = Dict[str, Dict[str, torch.Tensor]]
NetState = Dict[str, Dict[str, torch.Tensor]]

# keys by which a frozen serve tree carries a conv's fold already
FROZEN_FOLD_KEYS = ("_ep_scale", "_r_shift", "_r_shift_relu")


class FuncNet:
    """Layer instances + shape inference + eval forward for a NetGraph."""

    def __init__(self, graph: NetGraph, batch_size: int):
        self.graph = graph
        self.batch_size = batch_size
        self.layer_objs: List[Layer] = []
        self.node_shapes: List[Optional[Shape3]] = \
            [None] * graph.num_nodes
        self._build()

    def _build(self) -> None:
        g = self.graph
        if self._net_flag("channel_pad"):
            raise NotPortedError("channel_pad", Roadmap.CHECKPOINT_CLI)
        if self._net_flag("pool_concat_pallas"):
            raise NotPortedError("pool_concat_pallas = 1",
                                 Roadmap.POOL_CONCAT)
        if g.extra_data_num:
            raise NotPortedError("extra_data_num", Roadmap.CLI)
        self.node_shapes[0] = Shape3(*g.input_shape)
        for li, info in enumerate(g.layers):
            pli = g.param_layer_index(li)
            if info.type == "share":
                layer = self.layer_objs[pli]
            else:
                cfg = list(g.defcfg) + list(g.layercfg[li])
                kwargs = {}
                if g.effective_type(li) == "split":
                    kwargs["n_out"] = len(info.nindex_out)
                layer = create_layer(info.type, cfg, **kwargs)
                if layer.is_loss and layer.batch_size == 0:
                    layer.batch_size = self.batch_size
            self.layer_objs.append(layer)
            in_shapes = []
            for ni in info.nindex_in:
                s = self.node_shapes[ni]
                if s is None:
                    raise ValueError(
                        "layer %d reads node %d before it is produced"
                        % (li, ni))
                in_shapes.append(s)
            if layer.self_loop or info.nindex_in == info.nindex_out:
                if info.nindex_in != info.nindex_out:
                    raise ValueError(
                        "layer %d (%s) is a self-loop layer"
                        % (li, info.type))
            out_shapes = layer.infer_shape(in_shapes)
            for ni, s in zip(info.nindex_out, out_shapes):
                prev = self.node_shapes[ni]
                if prev is not None and ni not in info.nindex_in:
                    if prev != s:
                        raise ValueError(
                            "node %d shape conflict: %s vs %s"
                            % (ni, prev, s))
                self.node_shapes[ni] = s
        self._fusion_passes()

    def _net_flag(self, name: str, default: int = 0) -> int:
        """Net-level knob from the global (default) layer config."""
        val = default
        for n, v in self.graph.defcfg:
            if n == name:
                val = int(v)
        return val

    def _fusion_passes(self) -> None:
        g = self.graph
        self._identity_layers = set()     # relus folded into their BN
        self.fold_pairs: Dict[int, int] = {}   # conv li -> bn li
        self._fold_bns = set()
        self.bn_fold_eval = bool(self._net_flag("bn_fold_eval"))
        consumers = g.node_consumers()
        # a shared layer reuses its primary's object: fusing the
        # primary would drag the fusion to every share site
        shared_primaries = set(info.primary_layer_index
                               for info in g.layers
                               if info.type == "share")
        if self._net_flag("bn_fuse_relu"):
            for li, info in enumerate(g.layers):
                if info.type != "batch_norm" or li in shared_primaries:
                    continue
                cons = consumers.get(info.nindex_out[0], [])
                if len(cons) == 1 and g.layers[cons[0]].type == "relu":
                    self.layer_objs[li].fuse_relu = True
                    self._identity_layers.add(cons[0])
        if self.bn_fold_eval:
            for li, info in enumerate(g.layers):
                if info.type != "conv":
                    continue
                cons = consumers.get(info.nindex_out[0], [])
                if len(cons) == 1 and g.layers[cons[0]].type == "batch_norm":
                    self.fold_pairs[li] = cons[0]
                    self._fold_bns.add(cons[0])

    def fold_entries(self, params: Params, state: NetState,
                     conv_li: int) -> Dict[str, torch.Tensor]:
        """Per-out-channel scale/shift of a conv's BN partner (from its
        running stats), as the conv's params carry them."""
        bn_li = self.fold_pairs[conv_li]
        bn = self.layer_objs[bn_li]
        bkey = self.graph.layer_key(self.graph.param_layer_index(bn_li))
        scale, shift = bn.fold(params[bkey], state[bkey])
        out = {"_fold_scale": scale, "_fold_shift": shift}
        if bn.fuse_relu:
            out["_fold_relu"] = torch.ones(())   # key presence is the flag
        return out

    def init(self, seed: int):
        """Params and state on the CPU; each layer draws from its own
        generator seeded by (seed, layer index)."""
        g = self.graph
        params: Params = {}
        state: NetState = {}
        for li, info in enumerate(g.layers):
            if info.type == "share":
                continue
            lkey = g.layer_key(li)
            gen = torch.Generator().manual_seed(seed * 1000003 + li)
            p = self.layer_objs[li].init_params(gen)
            if p:
                params[lkey] = p
            s = self.layer_objs[li].init_state()
            if s:
                state[lkey] = s
        return params, state

    def forward(self, params: Params, state: NetState,
                data: torch.Tensor,
                is_train: bool = False) -> List[Optional[torch.Tensor]]:
        """Run all connections in config order; returns every node's
        value. Eval only."""
        if is_train:
            raise NotPortedError("the training forward", Roadmap.TRAINING)
        g = self.graph
        nodes: List[Optional[torch.Tensor]] = [None] * g.num_nodes
        if not data.is_floating_point():
            data = data.float()          # uint8 pixels normalize here
        nodes[0] = data
        for li, info in enumerate(g.layers):
            if li in self._identity_layers \
                    or (self.bn_fold_eval and li in self._fold_bns):
                # the epilogue already ran fused inside the producer
                v = nodes[info.nindex_in[0]]
                for ni in info.nindex_out:
                    nodes[ni] = v
                continue
            layer = self.layer_objs[li]
            pkey = g.layer_key(g.param_layer_index(li))
            p = params.get(pkey, {})
            if self.bn_fold_eval and li in self.fold_pairs \
                    and not any(k in p for k in FROZEN_FOLD_KEYS):
                p = dict(p)
                p.update(self.fold_entries(params, state, li))
            outs = layer.forward(p, state.get(pkey, {}),
                                 [nodes[ni] for ni in info.nindex_in])
            for ni, v in zip(info.nindex_out, outs):
                nodes[ni] = v
        return nodes

    def analytic_flops_per_example(self) -> float:
        """Analytic forward FLOPs per example (2*MACs over the conv and
        fullc contractions)."""
        g = self.graph
        total = 0
        for li in range(len(g.layers)):
            layer = self.layer_objs[li]
            t = g.effective_type(li)
            if t == "conv":
                p = layer.param
                out = layer.out_shapes[0]
                total += (2 * p.kernel_height * p.kernel_width
                          * (p.num_input_channel // p.num_group)
                          * out.ch * out.y * out.x)
            elif t == "fullc":
                p = layer.param
                total += 2 * p.num_input_node * p.num_hidden
        return float(total)

    def node_index_by_name(self, name: str) -> int:
        g = self.graph
        if name in g.node_name_map:
            return g.node_name_map[name]
        # "top[-k]" addressing: top = last node
        if name.startswith("top"):
            k = 0
            if name != "top":
                k = int(name[4:-1]) if name[3] == "[" else 0
            return g.num_nodes - 1 + k
        raise ValueError("unknown node name %r" % name)
