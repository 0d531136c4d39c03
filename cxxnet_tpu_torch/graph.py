"""Net-graph configuration: the ``layer[a->b] = type:name`` DSL.

A copy of ``cxxnet_tpu/graph.py``: parses the ordered config-pair
stream into a DAG of named nodes and layers, routing layer-scoped
parameters positionally, with

- ``layer[+1]`` / ``layer[+1:tag]`` / ``layer[+0]`` auto-chaining
- ``layer[src->dst]`` with comma-separated multi-node lists
- self-loop layers (``layer[3->3] = softmax``)
- shared layers (``layer[a->b] = share[tag]``)
- ``label_vec[a,b) = name`` multi-label field ranges
- ``extra_data_num`` / ``extra_data_shape[i]`` auxiliary inputs

``to_dict``/``from_dict`` give the structure record a snapshot carries
in ``__meta__["structure"]``; both packages read and write the same
record.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .utils.config import ConfigError, ConfigPairs

_RE_PLUS = re.compile(r"^layer\[\+(\d+)(?::([^\]]+))?\]$")
_RE_ARROW = re.compile(r"^layer\[([^\]>]+)->([^\]]+)\]$")
_RE_LABEL_VEC = re.compile(r"^label_vec\[(\d+),(\d+)\)$")
_RE_SHARE = re.compile(r"^share\[([^\]]+)\]$")


@dataclass
class LayerInfo:
    """One connection in the net DAG."""
    type: str                      # layer type string; 'share' for shared
    name: str = ""                 # optional layer name
    nindex_in: List[int] = field(default_factory=list)
    nindex_out: List[int] = field(default_factory=list)
    primary_layer_index: int = -1  # for shared layers: the primary layer

    def structure_equal(self, other: "LayerInfo") -> bool:
        return (self.type == other.type and self.name == other.name
                and self.nindex_in == other.nindex_in
                and self.nindex_out == other.nindex_out
                and self.primary_layer_index == other.primary_layer_index)


class NetGraph:
    """Parsed network structure + per-layer config + global net params."""

    def __init__(self) -> None:
        self.node_names: List[str] = []
        self.node_name_map: Dict[str, int] = {}
        self.layers: List[LayerInfo] = []
        self.layercfg: List[ConfigPairs] = []
        self.layer_name_map: Dict[str, int] = {}
        self.defcfg: ConfigPairs = []          # global (default) layer params
        self.input_shape: Tuple[int, int, int] = (0, 0, 0)   # (ch, y, x)
        self.extra_data_num: int = 0
        self.extra_shape: List[Tuple[int, int, int]] = []
        self.label_range: List[Tuple[int, int]] = []
        self.label_name_map: Dict[str, int] = {}
        self.updater_type: str = "sgd"
        self.batch_size: int = 0
        self._initialized = False

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    def configure(self, cfg: ConfigPairs) -> None:
        """Consume an ordered config stream. May be called again after
        a load: the structure must then match and only the per-layer and
        global params are re-applied."""
        first_time = not self._initialized
        if first_time:
            self.node_names = ["in"]
            self.node_name_map = {"in": 0, "0": 0}
        # a re-configure with NO netconfig block keeps the saved
        # per-layer params and in-net defaults
        has_netconfig = any(n == "netconfig" for n, _ in cfg)
        if first_time or has_netconfig:
            self.defcfg = []
            if not first_time:
                self.layercfg = [[] for _ in self.layers]

        netcfg_mode = 0     # 0: outside, 1: in netconfig, 2: after a layer line
        cfg_top_node = 0
        cfg_layer_index = 0

        for name, val in cfg:
            if name == "extra_data_num":
                num = int(val)
                for i in range(num):
                    nm = "in_%d" % (i + 1)
                    if nm not in self.node_name_map:
                        self.node_names.append(nm)
                        self.node_name_map[nm] = len(self.node_names) - 1
                self.extra_data_num = num
            if name.startswith("extra_data_shape["):
                z, y, x = (int(t) for t in val.split(","))
                self.extra_shape.append((z, y, x))
            if first_time and name == "input_shape":
                z, y, x = (int(t) for t in val.split(","))
                self.input_shape = (z, y, x)
            if name == "batch_size":
                self.batch_size = int(val)
            if netcfg_mode != 2:
                self._set_global_param(name, val)
            if name == "netconfig" and val == "start":
                netcfg_mode = 1
            if name == "netconfig" and val == "end":
                netcfg_mode = 0
            if name.startswith("layer["):
                info = self._parse_layer_line(name, val, cfg_top_node,
                                              cfg_layer_index)
                netcfg_mode = 2
                if first_time:
                    assert len(self.layers) == cfg_layer_index
                    self.layers.append(info)
                    self.layercfg.append([])
                else:
                    if cfg_layer_index >= len(self.layers):
                        raise ConfigError("config layer index exceeds bound")
                    if not info.structure_equal(self.layers[cfg_layer_index]):
                        raise ConfigError(
                            "config setting does not match existing network "
                            "structure at layer %d" % cfg_layer_index)
                cfg_top_node = (info.nindex_out[0]
                                if len(info.nindex_out) == 1 else -1)
                cfg_layer_index += 1
                continue
            if netcfg_mode == 2:
                if self.layers[cfg_layer_index - 1].type == "share":
                    raise ConfigError(
                        "do not set parameters in a shared layer; set them "
                        "in the primary layer")
                self.layercfg[cfg_layer_index - 1].append((name, val))
            else:
                self.defcfg.append((name, val))
        self._initialized = True
        self._validate()

    def to_dict(self) -> dict:
        """Serializable structure (the snapshot's ``structure`` record)."""
        return {
            "node_names": list(self.node_names),
            "layers": [{
                "type": l.type, "name": l.name,
                "nindex_in": list(l.nindex_in),
                "nindex_out": list(l.nindex_out),
                "primary_layer_index": l.primary_layer_index,
            } for l in self.layers],
            "layer_name_map": dict(self.layer_name_map),
            "layercfg": [[list(p) for p in lc] for lc in self.layercfg],
            "defcfg": [list(p) for p in self.defcfg],
            "input_shape": list(self.input_shape),
            "extra_data_num": self.extra_data_num,
            "extra_shape": [list(s) for s in self.extra_shape],
            "label_range": [list(r) for r in self.label_range],
            "label_name_map": dict(self.label_name_map),
            "updater_type": self.updater_type,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetGraph":
        g = cls()
        g.node_names = list(d["node_names"])
        g.node_name_map = {n: i for i, n in enumerate(g.node_names)}
        g.node_name_map["0"] = 0
        g.layers = [LayerInfo(type=l["type"], name=l["name"],
                              nindex_in=list(l["nindex_in"]),
                              nindex_out=list(l["nindex_out"]),
                              primary_layer_index=l["primary_layer_index"])
                    for l in d["layers"]]
        g.layercfg = [[tuple(p) for p in lc]
                      for lc in d.get("layercfg",
                                      [[] for _ in d["layers"]])]
        g.defcfg = [tuple(p) for p in d.get("defcfg", [])]
        g.layer_name_map = dict(d["layer_name_map"])
        g.input_shape = tuple(d["input_shape"])
        g.extra_data_num = d.get("extra_data_num", 0)
        g.extra_shape = [tuple(s) for s in d.get("extra_shape", [])]
        g.label_range = [tuple(r) for r in d.get("label_range", [])]
        g.label_name_map = dict(d.get("label_name_map", {}))
        g.updater_type = d.get("updater_type", "sgd")
        g._initialized = True
        return g

    def _set_global_param(self, name: str, val: str) -> None:
        if name == "updater":
            self.updater_type = val
        m = _RE_LABEL_VEC.match(name)
        if m:
            a, b = int(m.group(1)), int(m.group(2))
            self.label_range.append((a, b))
            self.label_name_map[val] = len(self.label_range) - 1

    def _get_node_index(self, tag: str, alloc_unknown: bool) -> int:
        if tag in self.node_name_map:
            return self.node_name_map[tag]
        if not alloc_unknown:
            raise ConfigError("unknown input node name %r" % tag)
        self.node_names.append(tag)
        idx = len(self.node_names) - 1
        self.node_name_map[tag] = idx
        return idx

    def _parse_node_list(self, spec: str, alloc_unknown: bool) -> List[int]:
        return [self._get_node_index(t.strip(), alloc_unknown)
                for t in spec.split(",")]

    def _parse_layer_line(self, name: str, val: str, top_node: int,
                          cfg_layer_index: int) -> LayerInfo:
        info = LayerInfo(type="")
        m = _RE_PLUS.match(name)
        if m:
            inc = int(m.group(1))
            tag = m.group(2)
            if top_node < 0:
                raise ConfigError(
                    "layer[+%d] used but previous layer has multiple "
                    "outputs; use layer[in->out] instead" % inc)
            info.nindex_in = [top_node]
            if tag is not None and inc == 1:
                info.nindex_out = [self._get_node_index(tag, True)]
            elif inc == 0:
                info.nindex_out = [top_node]
            else:
                auto = "!node-after-%d" % top_node
                info.nindex_out = [self._get_node_index(auto, True)]
        else:
            m = _RE_ARROW.match(name)
            if not m:
                raise ConfigError("invalid layer format %r" % name)
            info.nindex_in = self._parse_node_list(m.group(1), False)
            info.nindex_out = self._parse_node_list(m.group(2), True)

        # value: "type" | "type:name" | "share[tag]" | "share[tag]:name"
        ltype, _, lname = val.partition(":")
        ms = _RE_SHARE.match(ltype)
        if ms:
            info.type = "share"
            stag = ms.group(1)
            if stag not in self.layer_name_map:
                raise ConfigError(
                    "shared layer tag %r not defined before" % stag)
            info.primary_layer_index = self.layer_name_map[stag]
        else:
            info.type = ltype
            if lname:
                if lname in self.layer_name_map:
                    if self.layer_name_map[lname] != cfg_layer_index:
                        raise ConfigError(
                            "layer name %r does not match the name stored "
                            "in the model" % lname)
                else:
                    self.layer_name_map[lname] = cfg_layer_index
                info.name = lname
        return info

    def _validate(self) -> None:
        for li, info in enumerate(self.layers):
            if info.type == "share":
                p = self.layers[info.primary_layer_index]
                if p.type == "share":
                    raise ConfigError("shared layer cannot share a shared layer")
            for ni in info.nindex_in + info.nindex_out:
                if ni < 0 or ni >= len(self.node_names):
                    raise ConfigError(
                        "layer %d references invalid node %d" % (li, ni))

    def label_field_index(self, name: str) -> int:
        """Index of a named label field."""
        if name in self.label_name_map:
            return self.label_name_map[name]
        raise ConfigError("unknown label field %r" % name)

    def label_slices(self) -> List[Tuple[str, int, int]]:
        """(name, begin, end) column ranges into the label matrix; a
        single field ``label`` over column 0 when no ``label_vec`` is
        configured."""
        if not self.label_range:
            return [("label", 0, 1)]
        inv = {v: k for k, v in self.label_name_map.items()}
        return [(inv.get(i, "label"), a, b)
                for i, (a, b) in enumerate(self.label_range)]

    def node_consumers(self) -> Dict[int, List[int]]:
        """node index -> layer indices reading it (out-degree checks of
        the fusion passes in nnet/net.py)."""
        cons: Dict[int, List[int]] = {}
        for li, info in enumerate(self.layers):
            for ni in info.nindex_in:
                cons.setdefault(ni, []).append(li)
        return cons

    def effective_type(self, layer_index: int) -> str:
        """Resolve shared layers to their primary layer's type."""
        info = self.layers[layer_index]
        if info.type == "share":
            return self.layers[info.primary_layer_index].type
        return info.type

    def param_layer_index(self, layer_index: int) -> int:
        """Index of the layer owning the parameters (self, or primary if
        shared)."""
        info = self.layers[layer_index]
        return (info.primary_layer_index if info.type == "share"
                else layer_index)

    def layer_key(self, layer_index: int) -> str:
        """Stable key of a layer's parameters (snapshot ``param/<key>/``)."""
        info = self.layers[layer_index]
        return info.name if info.name else "layer%d" % layer_index
