"""Snapshot arrays <-> the port's parameter trees.

Both packages keep weights in the same logical layouts (conv HWIO,
fullc ``(in, out)``, per-channel vectors 1-D) under the snapshot keys
``param/<layer>/<tag>`` and ``state/<layer>/<name>``, so the arrays
cross unchanged; PyTorch's own layouts (OIHW channels-last conv
weights) are derived once, when the serve weights freeze.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device) -> Tuple[Tree, Tree]:
    """``param/...`` and ``state/...`` numpy arrays (a snapshot blob,
    or the JAX package's gathered arrays) -> (params, state) of float32
    tensors on ``device``. Other keys (``__meta__``, ``opt/``,
    ``quant/``) are ignored here."""
    params: Tree = {}
    state: Tree = {}
    for key, arr in arrays.items():
        kind, _, rest = key.partition("/")
        if kind not in ("param", "state"):
            continue
        lkey, _, tag = rest.rpartition("/")
        t = torch.from_numpy(np.array(arr, np.float32, copy=True))
        (params if kind == "param" else state).setdefault(
            lkey, {})[tag] = t.to(device)
    return params, state


def params_to_numpy(params: Tree, state: Tree) -> Dict[str, np.ndarray]:
    """The inverse: snapshot arrays of a (params, state) pair."""
    out: Dict[str, np.ndarray] = {}
    for kind, tree in (("param", params), ("state", state)):
        for lkey, sub in tree.items():
            for tag, t in sub.items():
                out["%s/%s/%s" % (kind, lkey, tag)] = \
                    t.detach().cpu().numpy()
    return out
