"""Config-file parsing: the ``key = value`` grammar of the reference.

A copy of ``cxxnet_tpu/utils/config.py`` (the port imports nothing of
the JAX package):

- tokens are whitespace-separated; ``=`` is its own token
- ``#`` starts a comment that runs to end-of-line
- double-quoted values may contain spaces and newlines
- a config is an *ordered* list of (name, value) pairs; ordering carries
  meaning (netconfig blocks route parameters positionally)

It also holds :class:`NotPortedError`, the typed error every module of
the port raises for a config key or input whose feature is not ported
yet, naming the ``ROADMAP.md`` item that will port it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

ConfigPairs = List[Tuple[str, str]]


class ConfigError(ValueError):
    """Raised on malformed configuration input."""


class Roadmap:
    """The ``ROADMAP.md`` items (queue and title) that port what a
    :class:`NotPortedError` reports. The C ABI, the serving front end
    (``task = serve_fleet``), ``serve_device_mem_budget``, sealed
    bundles (``task = export``), the continual loop (``task =
    continual``), the fleet tier (``task = fleet`` and
    ``fleet_balancer``), fp8 serving, retrieval (``task =
    build_index``) and rematerialization (``remat``) are ported and
    raise nothing."""
    MULTI_GPU = "queue 1, multi-GPU"


# Keys the reference reads that the port accepts and leaves without
# effect on purpose, each with its reason. None of them changes the
# reference's results beyond summation order; an update with any of
# them set is bit-identical to one without.
NO_OP_KEYS: Dict[str, str] = {
    "compile_cache_dir": "XLA's persistent compile cache "
                         "(cxxnet_tpu/nnet/trainer.py:238); the port "
                         "compiles no program (its kernel libraries "
                         "cache in _build/ beside the sources)",
    "serve_donate": "XLA's buffer donation on the serve dispatch "
                    "(cxxnet_tpu/nnet/trainer.py:257); eager PyTorch "
                    "frees a batch when its last reference goes",
    "temp_col_max": "the reference's im2col budget, parsed and unused "
                    "in the reference too (cxxnet_tpu/layers/conv.py:5-8, "
                    "base.py:148)",
    "conv_1x1_matmul": "a lowering choice of XLA for 1x1 convolutions "
                       "(cxxnet_tpu/layers/base.py:154); cuDNN picks "
                       "its own algorithm",
}


class NotPortedError(ConfigError):
    """A feature the reference supports but this port does not yet.

    ``feature`` names what was asked for (a config key and value, a
    layer type, a path kind); ``roadmap_item`` is the ``ROADMAP.md``
    entry that ports it (a :class:`Roadmap` value)."""

    def __init__(self, feature: str, roadmap_item: str):
        self.feature = feature
        self.roadmap_item = roadmap_item
        super().__init__("%s is not ported to cxxnet_tpu_torch yet "
                         "(ROADMAP.md %s)" % (feature, roadmap_item))


def _tokenize(text: str) -> Iterator[str]:
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 1
            if j >= n:
                raise ConfigError("unterminated quoted string in config")
            yield text[i + 1:j]
            i = j + 1
        elif c == "=":
            yield "="
            i += 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in '=#"':
                j += 1
            yield text[i:j]
            i = j


def parse_config(text: str) -> ConfigPairs:
    """Parse config text into an ordered list of (name, value) pairs."""
    pairs: ConfigPairs = []
    toks = _tokenize(text)
    for name in toks:
        try:
            eq = next(toks)
            if eq != "=":
                raise ConfigError(
                    "expected '=' after config key %r, got %r" % (name, eq))
            val = next(toks)
            if val == "=":
                raise ConfigError("missing value for config key %r" % name)
        except StopIteration:
            raise ConfigError("incomplete config entry for key %r" % name)
        pairs.append((name, val))
    return pairs


def parse_config_file(path: str) -> ConfigPairs:
    from .stream import open_stream
    with open_stream(path, "r") as f:
        return parse_config(f.read())


def parse_cli_overrides(args: List[str]) -> ConfigPairs:
    """Parse CLI ``key=value`` override arguments."""
    pairs: ConfigPairs = []
    for a in args:
        if "=" not in a:
            raise ConfigError("CLI override must be key=value, got %r" % a)
        k, v = a.split("=", 1)
        pairs.append((k.strip(), v.strip().strip('"')))
    return pairs


def split_sections(pairs: ConfigPairs) -> Tuple[List[Dict], ConfigPairs]:
    """Route ordered pairs into (iterator blocks, global pairs).

    Parameters between ``iter = <type>`` and ``iter = end`` belong to the
    data-source block most recently opened by a ``data = <name>`` /
    ``eval = <name>`` / ``pred = <val>`` marker. Everything else
    (including the netconfig block, which the net-graph parser routes
    itself) is global.

    Returns (blocks, global_pairs) where each block is a dict with keys
    ``kind`` ('data'|'eval'|'pred'), ``name``, and ``cfg`` (ordered pairs,
    starting with the chained ``iter`` entries).
    """
    blocks = []
    global_pairs: ConfigPairs = []
    cur = None          # pending data/eval/pred marker
    in_iter = False
    for name, val in pairs:
        if name in ("data", "eval", "pred") and not in_iter:
            cur = {"kind": name, "name": val, "cfg": []}
            continue
        if name == "iter":
            if val == "end":
                in_iter = False
                if cur is not None:
                    blocks.append(cur)
                    cur = None
                continue
            in_iter = True
            if cur is None:
                # iterator block with no marker: treated as anonymous data
                cur = {"kind": "data", "name": "", "cfg": []}
            cur["cfg"].append((name, val))
            continue
        if in_iter and cur is not None:
            cur["cfg"].append((name, val))
        else:
            global_pairs.append((name, val))
    if in_iter:
        raise ConfigError("iterator block not closed with 'iter = end'")
    return blocks, global_pairs
