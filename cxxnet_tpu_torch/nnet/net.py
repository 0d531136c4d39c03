"""The functional net: graph -> layer objects, shape inference, the
forward and the training loss (counterpart of
``cxxnet_tpu/nnet/net.py``). Backprop is autograd over ``loss_fn``;
there is no hand-written backward pass outside the kernels' own.

Net-level fusion passes of the reference that the port runs:

- ``bn_fuse_relu = 1``: a relu that is the sole consumer of a
  batch-norm output (``batch_norm_no_ma`` too) runs inside the BN
  layer; the relu connection becomes identity. It holds in training
  too.
- ``bn_fold_eval = 1`` (eval only): a moving-average batch_norm that solely
  consumes a conv's output folds its running-stats scale/shift into
  the conv (into the weight, or into the conv_epilogue kernel under
  ``conv_pallas_epilogue = 1``); the BN connection becomes identity.

- ``pool_concat_pallas = 1``: an Inception-tower ``ch_concat`` one of
  whose inputs is a stride-1, odd-k, SAME (pad k // 2), non-``pre_relu``
  max or avg pool consumed by that concat alone runs as one
  ``pool_concat`` kernel (``layers/kernels.py``), where the reference's
  gate admits its map (``pool_concat_applicable``, itemsize 2 under
  ``dtype = bfloat16``); the pool layer passes its input through. In
  training and at eval.

These change what interior nodes hold (the BN output node carries the
post-relu value; the conv output node the folded conv+BN value; a
fused pool's output node its un-pooled input), as in the reference.
``channel_pad`` is not ported and raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..graph import NetGraph
from ..layers import Layer, Shape3, create_layer
from ..layers.base import StepKey
from ..layers.conv import PoolingLayer
from ..layers.kernels import pool_concat_applicable
from ..utils.config import NotPortedError, Roadmap

Params = Dict[str, Dict[str, torch.Tensor]]
NetState = Dict[str, Dict[str, torch.Tensor]]

# keys by which a frozen serve tree carries a conv's fold already
FROZEN_FOLD_KEYS = ("_ep_scale", "_r_shift", "_r_shift_relu")
BN_TYPES = ("batch_norm", "pallas_batch_norm")


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
        if g.extra_data_num:
            raise NotPortedError("extra_data_num", Roadmap.IMAGE_PIPELINE)
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
                if info.type not in BN_TYPES + ("batch_norm_no_ma",) \
                        or li in shared_primaries:
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
                if len(cons) == 1 and g.layers[cons[0]].type in BN_TYPES:
                    self.fold_pairs[li] = cons[0]
                    self._fold_bns.add(cons[0])
        self._pool_passthrough = set()    # pools fused into their concat
        self.fused_concats: Dict[int, Tuple[int, int, str]] = {}
        if self._net_flag("pool_concat_pallas"):
            self._plan_pool_concat(consumers, shared_primaries)

    def _plan_pool_concat(self, consumers, shared_primaries) -> None:
        """Mark the Inception-tower ch_concat layers whose pool branch
        fuses (concat li -> (position, k, mode)), under the reference's
        conditions (``cxxnet_tpu/nnet/net.py:181-225``): the first input
        in order that comes from a max or avg pooling layer (not
        ``pre_relu``) with stride 1, a square odd window k > 1 and pad
        k // 2, whose output only this concat reads and whose map keeps
        its size, where the gate admits the concat's map; one fused
        branch per concat, none on a shared layer's primary."""
        g = self.graph
        producers: Dict[int, int] = {}
        for li, info in enumerate(g.layers):
            for ni in info.nindex_out:
                producers.setdefault(ni, li)
        itemsize = 2 if any(n == "dtype" and v == "bfloat16"
                            for n, v in g.defcfg) else 4
        for li, info in enumerate(g.layers):
            if info.type != "ch_concat" or li in shared_primaries:
                continue
            out_shape = self.node_shapes[info.nindex_out[0]]
            for pos, ni in enumerate(info.nindex_in):
                pli = producers.get(ni)
                if pli is None or g.layers[pli].type not in (
                        "max_pooling", "avg_pooling"):
                    continue
                pool = self.layer_objs[pli]
                if not isinstance(pool, PoolingLayer) or pool.pre_relu:
                    continue
                pp = pool.param
                k = pp.kernel_height
                if (pp.stride != 1 or k != pp.kernel_width or k <= 1
                        or k % 2 == 0 or pp.pad_y != k // 2
                        or pp.pad_x != k // 2):
                    continue
                if consumers.get(ni, []) != [li]:
                    continue
                ins = self.node_shapes[g.layers[pli].nindex_in[0]]
                outs = self.node_shapes[ni]
                if (ins.y, ins.x) != (outs.y, outs.x):
                    continue              # not a SAME-size pool
                if not pool_concat_applicable(out_shape.y, out_shape.x,
                                              out_shape.ch, k, itemsize):
                    continue
                self.fused_concats[li] = (pos, k, pool.mode)
                self.layer_objs[li].fused_pool = (pos, k, pool.mode)
                self._pool_passthrough.add(pli)
                break                     # one fused branch per concat

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
                data: torch.Tensor, is_train: bool = False,
                mask: Optional[torch.Tensor] = None,
                collect_logits: bool = False,
                rng: Optional[Tuple[int, int]] = None
                ) -> Tuple[List[Optional[torch.Tensor]], NetState,
                           Dict[int, torch.Tensor]]:
        """Run all connections in config order.

        Returns (node values, new state, loss inputs): the state after
        the training forward's running-stat updates (``state`` itself
        at eval), and per loss layer index its pre-transform input
        (only with ``collect_logits``). ``mask`` is the padded-row mask
        (1.0 real, 0.0 padding) or None when every row is real. ``rng``
        is the step's randomness, ``(seed, step)``: each stochastic
        layer gets its :class:`StepKey` with its connection index."""
        g = self.graph
        nodes: List[Optional[torch.Tensor]] = [None] * g.num_nodes
        if not data.is_floating_point():
            data = data.float()          # uint8 pixels normalize here
        nodes[0] = data
        new_state: NetState = dict(state)
        loss_inputs: Dict[int, torch.Tensor] = {}
        fold_eval = self.bn_fold_eval and not is_train
        for li, info in enumerate(g.layers):
            if li in self._identity_layers \
                    or li in self._pool_passthrough \
                    or (fold_eval and li in self._fold_bns):
                # the epilogue already ran fused inside the producer (relu
                # inside BN, BN inside the folded conv, the pool inside the
                # fused concat)
                v = nodes[info.nindex_in[0]]
                for ni in info.nindex_out:
                    nodes[ni] = v
                continue
            layer = self.layer_objs[li]
            pkey = g.layer_key(g.param_layer_index(li))
            p = params.get(pkey, {})
            s = new_state.get(pkey, {})
            if fold_eval and li in self.fold_pairs \
                    and not any(k in p for k in FROZEN_FOLD_KEYS):
                p = dict(p)
                p.update(self.fold_entries(params, state, li))
            ins = [nodes[ni] for ni in info.nindex_in]
            if collect_logits and layer.is_loss:
                loss_inputs[li] = ins[0]
            kw = {}
            if layer.needs_mask:
                kw["mask"] = mask
            if layer.needs_rng:
                kw["rng"] = None if rng is None \
                    else StepKey(rng[0], rng[1], li)
            outs, s2 = layer.forward(p, s, ins, is_train, **kw)
            if s2:
                new_state[pkey] = s2
            for ni, v in zip(info.nindex_out, outs):
                nodes[ni] = v
        return nodes, new_state, loss_inputs

    def loss_fn(self, params: Params, state: NetState,
                data: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor],
                collect_nodes: Sequence[int] = (),
                rng: Optional[Tuple[int, int]] = None):
        """Total training loss (sum over loss layers) and (new state,
        the values of ``collect_nodes``). ``labels`` is the (batch,
        label_width) matrix; each loss layer's ``target`` selects its
        columns through the graph's label fields. ``rng`` is the step's
        ``(seed, step)`` (see :meth:`forward`)."""
        nodes, new_state, loss_inputs = self.forward(
            params, state, data, is_train=True, mask=mask,
            collect_logits=True, rng=rng)
        slices = {name: (a, b) for name, a, b in self.graph.label_slices()}
        total = torch.zeros((), dtype=torch.float32, device=data.device)
        for li, logit in loss_inputs.items():
            layer = self.layer_objs[li]
            if layer.target not in slices:
                raise ValueError("loss layer: unknown target=%s"
                                 % layer.target)
            a, b = slices[layer.target]
            total = total + layer.loss_value(logit, labels[:, a:b], mask)
        return total, (new_state, [nodes[ni] for ni in collect_nodes])

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
            elif t in ("fullc", "pallas_fullc"):
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
