"""Snapshot arrays <-> the port's parameter trees.

Both packages keep weights in the same logical layouts (conv HWIO,
fullc ``(in, out)``, per-channel vectors 1-D) under the snapshot keys
``param/<layer>/<tag>`` and ``state/<layer>/<name>`` (every layer's
tags and names, e.g. prelu's slope ``bias``, a pairtest layer's
``slave:*`` and ``pairtest:max_diff``, insanity's ``lb``, ``ub`` and
int32 ``step``), and optimizer
state (``save_optimizer = 1``) in the layout of its weight under
``opt/<layer>/<tag>/<name>``, so the arrays cross unchanged;
PyTorch's own layouts (OIHW channels-last conv weights) are derived
when the serve weights freeze or, in training, on every step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]
OptTree = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device) -> Tuple[Tree, Tree]:
    """``param/...`` and ``state/...`` numpy arrays (a snapshot blob,
    or the JAX package's gathered arrays) -> (params, state) of tensors
    on ``device``: float32, and int32 for an integer array (insanity's
    ``step``). Other keys are ignored here: ``opt/`` is
    :func:`opt_from_numpy`'s, ``quant/`` ``quantize.tables_from_blob``'s.
    A tag may hold a ``:`` (a pairtest layer's ``slave:wmat``,
    ``pairtest:max_diff``)."""
    params: Tree = {}
    state: Tree = {}
    for key, arr in arrays.items():
        kind, _, rest = key.partition("/")
        if kind not in ("param", "state"):
            continue
        lkey, _, tag = rest.rpartition("/")
        dt = np.int32 if np.issubdtype(np.asarray(arr).dtype, np.integer) \
            else np.float32
        t = torch.from_numpy(np.array(arr, dt, copy=True))
        (params if kind == "param" else state).setdefault(
            lkey, {})[tag] = t.to(device)
    return params, state


def opt_from_numpy(arrays: Dict[str, np.ndarray], device) -> OptTree:
    """``opt/<layer>/<tag>/<name>`` arrays -> {layer: {tag: {name:
    float32 tensor on ``device``}}}; other keys are ignored."""
    opt: OptTree = {}
    for key, arr in arrays.items():
        kind, _, rest = key.partition("/")
        if kind != "opt":
            continue
        lkey, tag, name = rest.rsplit("/", 2)
        t = torch.from_numpy(np.array(arr, np.float32, copy=True))
        opt.setdefault(lkey, {}).setdefault(tag, {})[name] = t.to(device)
    return opt


def params_to_numpy(params: Tree, state: Tree,
                    opt_state: Optional[OptTree] = None
                    ) -> Dict[str, np.ndarray]:
    """The inverse: snapshot arrays of a (params, state) pair, and of
    the optimizer state when given. A bfloat16 buffer (``momentum_dtype
    = bfloat16``) is stored as float32, exactly: npz has no bf16. Each
    array is a private host copy (one device-to-host copy on the GPU; a
    copy, not a view, on the CPU), so a background snapshot writer may
    read it while later updates run."""
    out: Dict[str, np.ndarray] = {}
    for kind, tree in (("param", params), ("state", state)):
        for lkey, sub in tree.items():
            for tag, t in sub.items():
                out["%s/%s/%s" % (kind, lkey, tag)] = _host_copy(t)
    for lkey, tags in (opt_state or {}).items():
        for tag, st in tags.items():
            for name, t in st.items():
                if t.dtype == torch.bfloat16:
                    t = t.float()
                out["opt/%s/%s/%s" % (lkey, tag, name)] = _host_copy(t)
    return out


def _host_copy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()
