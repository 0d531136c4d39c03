"""The int8 contractions of the quantized serve path.

Counterpart of the ``preferred_element_type=int32`` products of the
reference's eval forward (``cxxnet_tpu/layers/conv.py:196-205`` and
``:268-280``, ``cxxnet_tpu/layers/common.py:80-88``), which the JAX
package leaves to XLA rather than to a Pallas kernel. Here they are
library products: ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card),
whose int32 sums are exact, fed by an im2col of the int8 NHWC input.

- a weight crosses once, at freeze, into the (N, K) row-major int8
  matrix the product reads (:func:`pack_weight`; K in the reference's
  HWIO order, kh, kw, then input channel);
- :func:`conv_int8` gathers each output pixel's (kh, kw, C) window into
  one row of an (M, K) int8 matrix with one strided copy (a 1x1
  stride-1 conv needs none: NHWC is already that matrix), then one
  product;
- :func:`dot_int8` is the fullc product.

``torch._int_mm`` on CUDA wants more than 16 rows and K and N that are
multiples of 8; the operands are zero-padded to that shape on every
device, so the CPU runs the card's code path. Zeros leave the int32
sums exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the shape rules of torch._int_mm on CUDA
ALIGN = 8
MIN_ROWS = 17


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """An int8 weight in the reference layout (conv HWIO, fullc ``(in,
    out)``) as the ``(N, K)`` row-major matrix the products read, N and
    K zero-padded to multiples of :data:`ALIGN`."""
    n = wq.shape[-1]
    m = wq.reshape(-1, n).t()
    k = m.shape[1]
    return F.pad(m, (0, _ceil(k, ALIGN) - k, 0,
                     _ceil(n, ALIGN) - n)).contiguous()


def _int_mm(a: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``a @ wm.T`` in exact int32 for a contiguous ``(M, Kp)`` int8
    ``a``; fewer than :data:`MIN_ROWS` rows are padded for the call."""
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    y = torch._int_mm(a, wm.t())
    return y[:m] if m < MIN_ROWS else y


def dot_int8(xq: torch.Tensor, wm: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``(M, n)`` product of an int8 ``(M, K)`` activation and a
    packed weight (:func:`pack_weight` of an ``(K, n)`` int8 weight)."""
    k, kp = xq.shape[1], wm.shape[1]
    if k != kp:
        xq = F.pad(xq, (0, kp - k))
    y = _int_mm(xq.contiguous(), wm)
    return y if wm.shape[0] == n else y[:, :n]


def conv_int8(xq: torch.Tensor, wm: torch.Tensor, n: int, kh: int,
              kw: int, stride: int, pad_y: int, pad_x: int
              ) -> torch.Tensor:
    """int32 NHWC output (contiguous) of an ungrouped convolution of an
    int8 NHWC ``xq`` with a packed HWIO weight (:func:`pack_weight`),
    zero padding, floor-mode output size."""
    b, h, w, c = xq.shape
    oh = (h + 2 * pad_y - kh) // stride + 1
    ow = (w + 2 * pad_x - kw) // stride + 1
    k, kp = kh * kw * c, wm.shape[1]
    if kh == kw == 1 and stride == 1 and not pad_y and not pad_x \
            and k == kp:
        cols = xq.contiguous().view(b * h * w, c)
    else:
        if pad_y or pad_x:
            xq = F.pad(xq, (0, 0, pad_x, pad_x, pad_y, pad_y))
        xq = xq.contiguous()
        sb, sh, sw, sc = xq.stride()
        win = xq.as_strided((b, oh, ow, kh, kw, c),
                            (sb, stride * sh, stride * sw, sh, sw, sc))
        cols = torch.empty((b * oh * ow, kp), dtype=torch.int8,
                           device=xq.device)
        if kp > k:
            cols[:, k:].zero_()
        cols.view(b, oh, ow, kp)[..., :k].view(b, oh, ow, kh, kw, c) \
            .copy_(win)
    y = _int_mm(cols, wm)
    del cols                             # the largest buffer of the conv
    if wm.shape[0] != n:
        y = y[:, :n].contiguous()
    return y.view(b, oh, ow, n)
