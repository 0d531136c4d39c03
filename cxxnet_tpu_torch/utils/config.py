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

from typing import Iterator, List, Tuple

ConfigPairs = List[Tuple[str, str]]


class ConfigError(ValueError):
    """Raised on malformed configuration input."""


class Roadmap:
    """The ``ROADMAP.md`` items (queue and title) that port what a
    :class:`NotPortedError` reports."""
    CLI = "queue 1, CLI tasks and iterators"
    LOW_PRECISION_TRAINING = "queue 1, low-precision training"
    REMAT = "queue 1, rematerialization"
    LAYER_ZOO = "queue 1, rest of the layer zoo"
    CHECKPOINT_CLI = "queue 1, checkpoint and CLI remainder"
    QUANTIZED = "queue 1, quantized and low-precision inference"
    BUNDLES = "queue 1, sealed bundles"
    MULTI_GPU = "queue 1, multi-GPU"
    CONV_EPILOGUE_INT32 = "queue 2, conv_epilogue int32 input and backward"
    POOL_CONCAT = "queue 2, pool_concat"


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
