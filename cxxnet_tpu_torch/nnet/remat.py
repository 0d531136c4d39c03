"""Rematerialization: the ``remat`` policies of the training step
(counterpart of ``cxxnet_tpu/nnet/trainer.py:478-520``, where
``jax.checkpoint`` wraps the loss).

What a policy keeps for the backward, as in the reference:

- ``full``: only the step's inputs (the batch; the weights are held by
  the trainer anyway);
- ``dots``: besides those, the outputs of the layers whose output is one
  non-batched ``torch.matmul`` product (``fullc``, ``fixconn``: a
  ``pallas_fullc`` product is a kernel launch, as the reference's is a
  ``pallas_call``, not a dot);
- ``conv``: besides those, only the conv layers' outputs (the layers'
  ``remat_name``, the reference's ``conv_out`` tag).

Everything else is recomputed in the backward. The connections are cut
into segments at the kept values: a segment is a group of connections
joined by the values they pass that are not kept. Each segment runs
under ``torch.utils.checkpoint`` (non-reentrant, as the step
differentiates with ``torch.autograd.grad``), so the forward keeps a
segment's inputs (kept values) and nothing of its inside, and the
backward recomputes a segment when it first needs one of its values.

XLA recomputes the reference's ``full`` and ``dots`` forward in one
piece, so the backward holds every value again at once. Eager PyTorch
has no scheduler to do better, so under those two policies each
segment's recompute is itself cut at the conv outputs: the forward still
keeps only what the policy says, and the backward holds one conv
segment's values at a time. That recomputes the forward once more
inside those segments.

The recompute gives the same values: the layers' randomness is drawn
from generators seeded by ``(seed, step, layer)``
(``layers.common.dropout_uniform``), not from the global generator, so
the checkpoint does not stash the global RNG state. The running
statistics of batch norm come from the forward; a recompute's are
dropped. Each recompute launches the hand kernels of its connections
again (``bn_apply``, ``matmul``, ``relu_max_pool``, ``pool_concat``,
``bias_grad_bf16``'s forward has none).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch.utils.checkpoint import checkpoint

# the names each policy keeps, outermost cut first; a second entry cuts
# the recompute of each outer segment again
_LEVELS = {"full": ((), ("conv_out",)),
           "dots": (("dot",), ("dot", "conv_out")),
           "conv": (("conv_out",),)}

Key = Tuple[int, int]            # (node, the connection that wrote it;
#                                  -1 for the step's inputs)


class Segment(NamedTuple):
    """Connections recomputed together: ``layers`` in config order (or
    ``inner`` segments), the values they read from outside
    (``inputs``), those read outside or collected (``outputs``) and the
    loss layers whose terms they compute (``losses``)."""
    layers: Tuple[int, ...]
    inputs: Tuple[Key, ...]
    outputs: Tuple[Key, ...]
    losses: Tuple[int, ...]
    inner: Optional[Tuple["Segment", ...]]


def _keys(net):
    """Per connection, the keys of the values it reads; per node, its
    last writer."""
    g = net.graph
    writer = {n: -1 for n in range(1 + g.extra_data_num)}
    reads = []
    for li, info in enumerate(g.layers):
        reads.append(tuple((n, writer[n]) for n in info.nindex_in))
        for n in info.nindex_out:
            writer[n] = li
    return reads, writer


def _kept_writers(net, reads, names) -> List[bool]:
    """Per connection, whether a policy keeping ``names`` keeps its
    output (a pass-through keeps what its input's writer does)."""
    kept = []
    for li, layer in enumerate(net.layer_objs):
        if net.passes_through(li):
            w = reads[li][0][1]
            kept.append(w < 0 or kept[w])
        else:
            kept.append(layer.remat_name in names)
    return kept


def _groups(layers: Sequence[int], reads, kept) -> List[List[int]]:
    """``layers`` cut at the kept values: connections joined by a value
    that is not kept share a group; groups on a cycle of kept values
    read across them are merged, so the groups run in an order. Returns
    the groups in a topological order (the lowest connection first where
    free)."""
    parent = {li: li for li in layers}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for li in layers:
        for _, w in reads[li]:
            if w in parent and not kept[w]:
                parent[find(li)] = find(w)
    while True:
        root = {li: find(li) for li in layers}
        edges = {r: set() for r in set(root.values())}
        for li in layers:
            for _, w in reads[li]:
                if w in root and root[w] != root[li]:
                    edges[root[w]].add(root[li])
        cycle = _find_cycle(edges)
        if not cycle:
            break
        for r in cycle[1:]:
            parent[find(r)] = find(cycle[0])
    # Kahn's order, the group of the lowest connection first
    indeg = {r: 0 for r in edges}
    for r in edges:
        for d in edges[r]:
            indeg[d] += 1
    members: Dict[int, List[int]] = {}
    for li in layers:
        members.setdefault(root[li], []).append(li)
    ready = sorted((min(members[r]), r) for r in edges if indeg[r] == 0)
    order = []
    while ready:
        _, r = ready.pop(0)
        order.append(members[r])
        for d in edges[r]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append((min(members[d]), d))
                ready.sort()
    return order


def _find_cycle(edges) -> List[int]:
    """A cycle of the graph ``edges`` (node -> successors) as a list of
    its nodes, or [] when it has none."""
    color: Dict[int, int] = {}
    stack: List[int] = []

    def visit(u) -> List[int]:
        color[u] = 1
        stack.append(u)
        for v in sorted(edges[u]):
            if color.get(v) == 1:
                return stack[stack.index(v):]
            if v not in color:
                c = visit(v)
                if c:
                    return c
        color[u] = 2
        stack.pop()
        return []

    for u in sorted(edges):
        if u not in color:
            c = visit(u)
            if c:
                return c
    return []


def plan(net, policy: str, collect: Sequence[int] = ()) -> List[Segment]:
    """The segments of ``net``'s training forward under ``policy``
    (``full | dots | conv``), with the final values of the nodes in
    ``collect`` among their outputs."""
    if policy not in _LEVELS:
        raise ValueError("remat must be none|full|dots|conv")
    g = net.graph
    reads, writer = _keys(net)
    wanted = {(n, writer[n]) for n in collect}
    read_by: Dict[Key, set] = {}
    for li, keys in enumerate(reads):
        for k in keys:
            read_by.setdefault(k, set()).add(li)

    def segments(layers, level) -> List[Segment]:
        names = _LEVELS[policy][level]
        kept = _kept_writers(net, reads, names)
        out = []
        for group in _groups(layers, reads, kept):
            inside = set(group)
            ins, outs = [], []
            for li in group:
                for k in reads[li]:
                    if k[1] not in inside and k not in ins:
                        ins.append(k)
                for n in g.layers[li].nindex_out:
                    k = (n, li)
                    if k not in outs and (k in wanted or read_by.get(
                            k, set()) - inside):
                        outs.append(k)
            inner = None
            if level + 1 < len(_LEVELS[policy]):
                inner = tuple(segments(group, level + 1))
                if len(inner) == 1:
                    inner = None
            losses = tuple(li for li in group
                           if net.layer_objs[li].is_loss)
            out.append(Segment(tuple(group), tuple(ins), tuple(outs),
                               losses, inner))
        return out

    return segments(list(range(len(g.layers))), 0)


def remat_forward(net, policy: str, params, state, data: torch.Tensor,
                  mask: Optional[torch.Tensor], rng, extra,
                  collect: Sequence[int],
                  loss_of: Callable[[int, torch.Tensor], torch.Tensor]):
    """The training forward of ``FuncNet.loss_fn`` under ``policy``:
    (the values of ``collect``, the new state, {loss layer: its term})."""
    key = (policy, tuple(collect))
    if key not in net.remat_plans:
        net.remat_plans[key] = plan(net, policy, collect)
    segs = net.remat_plans[key]
    reads, writer = _keys(net)
    g = net.graph
    if not data.is_floating_point():
        data = data.float()              # uint8 pixels normalize here
    vals: Dict[Key, torch.Tensor] = {(0, -1): data}
    for i in range(g.extra_data_num):
        vals[(1 + i, -1)] = extra[i]
    new_state = dict(state)
    terms: Dict[int, torch.Tensor] = {}

    def run(segs, vals, new_state, terms) -> None:
        for seg in segs:
            holder: Dict[str, dict] = {}
            start = dict(new_state)

            def fn(*xs, seg=seg, holder=holder, start=start):
                local = dict(zip(seg.inputs, xs))
                st = dict(start)
                lterms: Dict[int, torch.Tensor] = {}
                if seg.inner is not None:
                    run(seg.inner, local, st, lterms)
                else:
                    for li in seg.layers:
                        logits: Dict[int, torch.Tensor] = {}
                        outs = net.apply_layer(
                            li, [local[k] for k in reads[li]], params,
                            state, st, True, mask, rng, logits)
                        for n, v in zip(g.layers[li].nindex_out, outs):
                            local[(n, li)] = v
                        if li in logits:
                            lterms[li] = loss_of(li, logits[li])
                # the forward's state; a recompute's is dropped
                holder.setdefault("state", st)
                return tuple(local[k] for k in seg.outputs) \
                    + tuple(lterms[li] for li in seg.losses)

            outs = checkpoint(fn, *[vals[k] for k in seg.inputs],
                              use_reentrant=False, preserve_rng_state=False)
            vals.update(zip(seg.outputs, outs))
            terms.update(zip(seg.losses, outs[len(seg.outputs):]))
            new_state.update(holder["state"])

    run(segs, vals, new_state, terms)
    return [vals[(n, writer[n])] for n in collect], new_state, terms
