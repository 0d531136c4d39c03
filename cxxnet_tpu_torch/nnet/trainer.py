"""NetTrainer, serve-side subset (counterpart of
``cxxnet_tpu/nnet/trainer.py``).

What is ported: model init and snapshot load/save, the one-time freeze
of the eval weights (``freeze_serve_weights``), the eval forward behind
``predict`` / ``extract_feature``, and the reference-layout weight
get/set. Training (``update``, updaters, metrics) comes with the
training slice.

The freeze is the reference's device-resident serve weight tree
(``serve_weight_residency = 1``, the default): the BN fold vectors are
computed once at load, never per dispatch, and each conv weight is
converted once to PyTorch's OIHW channels-last layout. Under
``conv_pallas_epilogue = 1`` the weight stays raw and the fold
(scale, and the shift with any conv bias folded in) goes to the
conv_epilogue kernel; otherwise the scale multiplies the weight.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import NetGraph
from ..io.data import DataBatch
from ..layers.conv import hwio_to_oihw
from ..utils.config import (ConfigError, ConfigPairs, NotPortedError,
                            Roadmap)
from ..utils.stream import local_path
from .checkpoint import read_snapshot, write_snapshot
from .convert import Tree, params_from_numpy, params_to_numpy
from .net import FuncNet

SERVE_DTYPES = ("float32", "bfloat16", "int8", "fp8")
_DTYPE_ALIAS = {"f32": "float32", "bf16": "bfloat16", "float8": "fp8",
                "float8_e4m3": "fp8"}


def normalize_serve_dtype(val: str) -> str:
    """Canonical ``serve_dtype`` value; only float32 is ported."""
    v = _DTYPE_ALIAS.get(val, val)
    if v not in SERVE_DTYPES:
        raise ConfigError("serve_dtype must be one of %s (got %r)"
                          % ("|".join(SERVE_DTYPES), val))
    if v != "float32":
        raise NotPortedError("serve_dtype = %s" % v, Roadmap.QUANTIZED)
    return v


class NetTrainer:
    """A net and its weights on one device, for evaluation.

    ``device`` defaults to the GPU; without one it raises unless the
    caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: ConfigPairs = (), device=None):
        self.cfg: List[Tuple[str, str]] = list(cfg)
        self.device = resolve_device(device)
        self.batch_size = 0
        self.seed = 0
        self.serve_dtype = "float32"
        self.serve_weight_residency = 1
        self.update_counter = 0
        self._serve_tree: Optional[Tree] = None
        self._initialized = False

    # -- config ----------------------------------------------------------

    def _absorb_globals(self) -> None:
        for name, val in self.cfg:
            if name == "batch_size":
                self.batch_size = int(val)
            if name == "seed":
                self.seed = int(val)
            if name == "serve_dtype":
                self.serve_dtype = normalize_serve_dtype(val)
            if name == "serve_weight_residency":
                self.serve_weight_residency = int(val)
            if name == "serve_device_mem_budget" and float(val):
                raise NotPortedError("serve_device_mem_budget",
                                     Roadmap.QUANTIZED)
            if name == "input_layout" and val != "none":
                raise NotPortedError("input_layout = %s" % val,
                                     Roadmap.CHECKPOINT_CLI)

    # -- model lifecycle -------------------------------------------------

    def _build_net(self) -> None:
        if self.batch_size == 0:
            self.batch_size = self.graph.batch_size
        if self.batch_size <= 0:
            raise ConfigError("batch_size must be set")
        self.net = FuncNet(self.graph, self.batch_size)

    def init_model(self) -> None:
        """A fresh model: weights drawn from ``seed``."""
        self._absorb_globals()
        self.graph = NetGraph()
        self.graph.configure(self.cfg)
        self._build_net()
        params, state = self.net.init(self.seed)
        self._install(params, state)

    def load_model(self, path: str) -> None:
        """Load a snapshot (either package's), digest verified."""
        if os.path.isdir(local_path(path)):
            raise NotPortedError("a bundle as model_path (%r)" % path,
                                 Roadmap.BUNDLES)
        blob, meta = read_snapshot(path)
        self._absorb_globals()
        self.graph = NetGraph.from_dict(meta["structure"])
        self.graph.configure(self.cfg)
        self._build_net()
        params, state = self.net.init(self.seed)
        saved_p, saved_s = params_from_numpy(blob, "cpu")
        for tree, saved in ((params, saved_p), (state, saved_s)):
            for lk, sub in tree.items():
                for tag in sub:
                    if tag in saved.get(lk, {}):
                        sub[tag] = saved[lk][tag]
        self.update_counter = int(meta.get("update_counter", 0))
        self._install(params, state)

    def _install(self, params: Tree, state: Tree) -> None:
        dev = self.device
        self.params = {lk: {t: v.to(dev) for t, v in sub.items()}
                       for lk, sub in params.items()}
        self.net_state = {lk: {t: v.to(dev) for t, v in sub.items()}
                          for lk, sub in state.items()}
        self._serve_tree = None
        self._initialized = True

    # -- frozen serve weights --------------------------------------------

    def freeze_serve_weights(self) -> Optional[Tree]:
        """Build (once) the eval weight tree every pred forward reads:
        per conv the OIHW weight and the BN fold (see the module
        docstring). None when ``serve_weight_residency = 0``: the
        forward then folds and converts per call, as the reference's
        legacy path does."""
        assert self._initialized, "call init_model/load_model first"
        if not self.serve_weight_residency:
            return None
        if self._serve_tree is not None:
            return self._serve_tree
        net, g = self.net, self.graph
        shared_primaries = set(info.primary_layer_index
                               for info in g.layers
                               if info.type == "share")
        tree = {lk: dict(sub) for lk, sub in self.params.items()}
        with torch.no_grad():
            for li, info in enumerate(g.layers):
                if info.type != "conv":
                    continue
                lkey = g.layer_key(li)
                p, t = self.params[lkey], tree[lkey]
                layer = net.layer_objs[li]
                w = p["wmat"]
                if (net.bn_fold_eval and li in net.fold_pairs
                        and li not in shared_primaries):
                    fe = net.fold_entries(self.params, self.net_state, li)
                    scale, shift = fe["_fold_scale"], fe["_fold_shift"]
                    if layer.param.no_bias == 0:
                        shift = shift + p["bias"] * scale
                    relu = "_fold_relu" in fe
                    if layer.param.conv_pallas_epilogue:
                        t["_ep_scale"] = scale.contiguous()
                        t["_ep_shift"] = shift.contiguous()
                        if relu:
                            t["_ep_relu"] = fe["_fold_relu"]
                    else:
                        w = w * scale
                        t["_r_shift_relu" if relu else "_r_shift"] = shift
                t["_oihw"] = hwio_to_oihw(w)
        self._serve_tree = tree
        return tree

    def _pred_operands(self) -> Tree:
        tree = self.freeze_serve_weights()
        return self.params if tree is None else tree

    def pred(self, data: torch.Tensor,
             nodes_wanted: Sequence[int]) -> List[torch.Tensor]:
        """Eval forward of a device batch; float32 values of the wanted
        nodes, on the device."""
        params = self._pred_operands()
        with torch.inference_mode():
            nodes = self.net.forward(params, self.net_state, data)
            return [nodes[i].float() for i in nodes_wanted]

    def to_device_batch(self, x) -> torch.Tensor:
        """Host rows -> a device tensor: uint8 pixels ship raw (the net
        normalizes them), everything else as float32."""
        a = np.asarray(x)
        if a.dtype != np.uint8:
            a = a.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def rows_to_prediction(m: np.ndarray) -> np.ndarray:
        """Output rows -> per-row prediction: the single raw column, or
        the argmax class as float32."""
        m = m.reshape(m.shape[0], -1)
        if m.shape[1] == 1:
            return m[:, 0]
        return np.argmax(m, axis=1).astype(np.float32)

    def predict(self, batch: DataBatch) -> np.ndarray:
        """argmax class (or raw scalar) per row of the top node."""
        top = self.graph.num_nodes - 1
        (val,) = self.pred(self.to_device_batch(batch.data), (top,))
        nvalid = batch.batch_size - batch.num_batch_padd
        out = val[:nvalid].cpu().numpy()
        return self.rows_to_prediction(out)

    def extract_feature(self, batch: DataBatch, node: str) -> np.ndarray:
        """The node's value for the valid rows, in its natural shape."""
        ni = self.net.node_index_by_name(node)
        (val,) = self.pred(self.to_device_batch(batch.data), (ni,))
        nvalid = batch.batch_size - batch.num_batch_padd
        return val[:nvalid].cpu().numpy()

    # -- weights ---------------------------------------------------------

    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        """Weight in reference convention: fullc (out, in); conv
        (out_ch, in_pg*kh*kw); vectors 1-D."""
        w = self.params[layer_name][tag].detach().cpu().numpy()
        return self._to_ref_layout(w)

    def set_weight(self, layer_name: str, tag: str,
                   value: np.ndarray) -> None:
        cur = self.params[layer_name][tag]
        new = self._from_ref_layout(np.asarray(value, np.float32),
                                    tuple(cur.shape))
        self.params[layer_name] = dict(self.params[layer_name])
        self.params[layer_name][tag] = torch.from_numpy(new).to(self.device)
        self._serve_tree = None          # the frozen tree is stale

    @staticmethod
    def _to_ref_layout(w: np.ndarray) -> np.ndarray:
        if w.ndim == 2:                      # fullc (in,out) -> (out,in)
            return w.T.copy()
        if w.ndim == 4:                      # HWIO -> (out, in*kh*kw)
            kh, kw, ipg, out = w.shape
            return w.transpose(3, 2, 0, 1).reshape(out, ipg * kh * kw)
        return w.copy()

    @staticmethod
    def _from_ref_layout(w: np.ndarray,
                         target_shape: Tuple[int, ...]) -> np.ndarray:
        if len(target_shape) == 2:
            return np.ascontiguousarray(w.T)
        if len(target_shape) == 4:
            kh, kw, ipg, out = target_shape
            return np.ascontiguousarray(
                w.reshape(out, ipg, kh, kw).transpose(2, 3, 1, 0))
        return np.ascontiguousarray(w.reshape(target_shape))

    # -- checkpoint ------------------------------------------------------

    def gather_snapshot(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Everything a snapshot holds, as host arrays, and its meta."""
        arrays = params_to_numpy(self.params, self.net_state)
        meta = {
            "update_counter": self.update_counter,
            "structure": self.graph.to_dict(),
            "cfg": [list(p) for p in self.cfg],
        }
        return arrays, meta

    def save_model(self, path: str) -> None:
        """Verified snapshot, atomically committed."""
        arrays, meta = self.gather_snapshot()
        write_snapshot(path, arrays, meta)
