"""Batch-size buckets: the shape vocabulary of the serve path (a copy of
``cxxnet_tpu/serve/bucketing.py``).

Every micro-batch rounds up to a small ladder of batch sizes and pads
its tail rows, so the set of shapes a server runs is the set its warmup
ran. On the GPU the ladder bounds the cuDNN algorithm choices and the
caching allocator's block sizes the way it bounds compiled programs on
the TPU.
"""

from __future__ import annotations

from math import gcd
from typing import Optional, Sequence, Tuple

import numpy as np

# the default ladder below max_batch; max_batch itself is always a
# bucket
DEFAULT_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)


def bucket_ladder(max_batch: int, align: int = 1,
                  base: Sequence[int] = DEFAULT_LADDER) -> Tuple[int, ...]:
    """Ascending bucket sizes ending at ``max_batch``; candidates that
    are not multiples of ``align`` (the data-parallel width) drop."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    if align < 1 or max_batch % align:
        raise ValueError(
            "max_batch %d must be a multiple of the mesh data axis %d"
            % (max_batch, align))
    out = sorted({b for b in base
                  if 0 < b < max_batch and b % align == 0}
                 | {max_batch})
    return tuple(out)


def parse_buckets(spec: str, max_batch: int,
                  align: int = 1) -> Tuple[int, ...]:
    """Parse the ``serve_buckets`` config value: ``auto`` (the default
    ladder) or an explicit comma list like ``1,8,32``, validated and
    always including ``max_batch``."""
    if not spec or spec == "auto":
        return bucket_ladder(max_batch, align)
    sizes = sorted({int(t) for t in spec.split(",") if t.strip()})
    for b in sizes:
        if b < 1 or b > max_batch:
            raise ValueError(
                "serve bucket %d outside [1, max_batch=%d]"
                % (b, max_batch))
        if b % align:
            raise ValueError(
                "serve bucket %d must be a multiple of the mesh data "
                "axis %d" % (b, align))
    if max_batch % align:
        raise ValueError(
            "max_batch %d must be a multiple of the mesh data axis %d"
            % (max_batch, align))
    if not sizes or sizes[-1] != max_batch:
        sizes.append(max_batch)
    return tuple(sizes)


def pick_bucket(n: int, buckets: Sequence[int],
                extend: bool = False) -> Optional[int]:
    """Smallest bucket >= ``n``; None when ``n`` exceeds the ladder and
    ``extend`` is off; with ``extend`` oversized requests round up to
    ``max_bucket * 2**k``."""
    if n < 1:
        raise ValueError("batch of %d rows" % n)
    for b in buckets:
        if b >= n:
            return b
    if not extend:
        return None
    m = buckets[-1]
    while m < n:
        m *= 2
    return m


def reachable_variants(
        buckets: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The ``(bucket, rows)`` dispatch variants steady-state traffic can
    reach: every bucket exactly full, plus — when some row count rounds
    up to it — the smallest such count (``prev_bucket + 1``)."""
    out = []
    prev = 0
    for b in sorted({int(x) for x in buckets}):
        out.append((b, b))
        if prev + 1 < b:
            out.append((b, prev + 1))
        prev = b
    return tuple(out)


def mesh_align(buckets: Sequence[int], max_devices: int) -> int:
    """Largest data-parallel width <= ``max_devices`` that divides every
    bucket."""
    g = 0
    for b in buckets:
        g = gcd(g, int(b))
    d = max(1, min(g, max_devices))
    while g % d:
        d -= 1
    return d


def pad_to_bucket(rows: np.ndarray,
                  bucket: int) -> Tuple[np.ndarray, int]:
    """Pad ``rows`` with zero rows up to ``bucket``; returns (padded,
    num_batch_padd). A full bucket passes through without a copy."""
    n = rows.shape[0]
    if n > bucket:
        raise ValueError("cannot pad %d rows into a bucket of %d"
                         % (n, bucket))
    if n == bucket:
        return rows, 0
    pad = np.zeros((bucket - n,) + rows.shape[1:], rows.dtype)
    return np.concatenate([rows, pad], axis=0), bucket - n
