"""The int8 and fp8 contractions of the quantized serve path.

Counterpart of the ``preferred_element_type=int32|float32`` products of
the reference's eval forward (``cxxnet_tpu/layers/conv.py:196-205`` and
``:268-280``, ``cxxnet_tpu/layers/common.py:80-88``), which the JAX
package leaves to XLA rather than to a Pallas kernel. Here they are
library products fed by an im2col of the quantized NHWC input:
``torch._int_mm`` (cuBLASLt's int8 GEMM on the card), whose int32 sums
are exact, and ``torch._scaled_mm`` on e4m3 operands with unit scales
and float32 output (the dequant stays in the conv epilogue, as in the
reference).

- a weight crosses once, at freeze, into the (N, K) row-major int8 or
  e4m3 matrix the product reads (:func:`pack_weight`; K in the
  reference's HWIO order, kh, kw, then input channel);
- :func:`conv_int8` / :func:`conv_fp8` gather each output pixel's (kh,
  kw, C) window into one row of an (M, K) matrix with one strided copy
  (a 1x1 stride-1 conv needs none: NHWC is already that matrix), then
  one product. The gather moves bytes, so the e4m3 operand goes
  through it as int8 (the same bytes; zero is zero in both);
- :func:`dot_int8` / :func:`dot_fp8` are the fullc products.

``torch._int_mm`` on CUDA wants more than 16 rows and K and N that are
multiples of 8; ``torch._scaled_mm`` on sm_90 wants K and N multiples
of 16 and its second operand column-major. The operands are
zero-padded to those shapes on every device, so the CPU runs the
card's code path up to the fp8 product itself, which on the CPU widens
to float32: oneDNN's fp8 matmul behind ``torch._scaled_mm`` does not
run on every host CPU. Zeros add nothing to either sum.
``use_fast_accum`` stays off: Hopper's fast fp8 accumulation keeps
partial sums at reduced precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the shape rules of torch._int_mm on CUDA
ALIGN = 8
MIN_ROWS = 17
# torch._scaled_mm's on sm_90: K and N multiples of 16
FP8_ALIGN = 16

FP8 = torch.float8_e4m3fn
_ALIGN = {"int8": ALIGN, "fp8": FP8_ALIGN}


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def pack_weight(wq: torch.Tensor, dtype: str = "int8") -> torch.Tensor:
    """An int8 (or e4m3, ``dtype = "fp8"``) weight in the reference
    layout (conv HWIO, fullc ``(in, out)``) as the ``(N, K)`` row-major
    matrix the products read, N and K zero-padded to multiples of
    :data:`ALIGN` (:data:`FP8_ALIGN`)."""
    align = _ALIGN[dtype]
    n = wq.shape[-1]
    m = wq.contiguous().view(torch.int8).reshape(-1, n).t()
    k = m.shape[1]
    m = F.pad(m, (0, _ceil(k, align) - k, 0,
                  _ceil(n, align) - n)).contiguous()
    return m.view(FP8) if dtype == "fp8" else m


def _int_mm(a: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``a @ wm.T`` in exact int32 for a contiguous ``(M, Kp)`` int8
    ``a``; fewer than :data:`MIN_ROWS` rows are padded for the call."""
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    y = torch._int_mm(a, wm.t())
    return y[:m] if m < MIN_ROWS else y


def _fp8_mm(a: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``a @ wm.T`` in float32 for a contiguous ``(M, Kp)`` e4m3 ``a``
    and a packed e4m3 weight: on the card one ``torch._scaled_mm`` with
    unit scales; on the CPU the e4m3 values widened to float32 and
    multiplied (each product exact, the sums in float32), as XLA:CPU
    computes the reference's."""
    if a.device.type != "cuda":
        return a.float() @ wm.float().t()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(a, wm.t(), scale_a=one, scale_b=one,
                            out_dtype=torch.float32, use_fast_accum=False)


def _pad_k(xq: torch.Tensor, kp: int) -> torch.Tensor:
    """A contiguous ``(M, kp)`` operand: zero columns appended to an
    ``(M, K)`` one (through its int8 view, so e4m3 pads alike)."""
    k = xq.shape[1]
    if k == kp:
        return xq.contiguous()
    return F.pad(xq.view(torch.int8), (0, kp - k)).view(xq.dtype)


def dot_int8(xq: torch.Tensor, wm: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``(M, n)`` product of an int8 ``(M, K)`` activation and a
    packed weight (:func:`pack_weight` of an ``(K, n)`` int8 weight)."""
    y = _int_mm(_pad_k(xq, wm.shape[1]), wm)
    return y if wm.shape[0] == n else y[:, :n]


def dot_fp8(xq: torch.Tensor, wm: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``(M, n)`` product of an e4m3 ``(M, K)`` activation and a
    packed e4m3 weight (:func:`pack_weight` with ``dtype = "fp8"``)."""
    y = _fp8_mm(_pad_k(xq, wm.shape[1]), wm)
    return y if wm.shape[0] == n else y[:, :n]


def _im2col(xq: torch.Tensor, kp: int, kh: int, kw: int, stride: int,
            pad_y: int, pad_x: int) -> torch.Tensor:
    """The ``(B*OH*OW, kp)`` int8 matrix of an int8 NHWC ``xq``'s
    windows, K zero-padded to ``kp``."""
    b, h, w, c = xq.shape
    oh = (h + 2 * pad_y - kh) // stride + 1
    ow = (w + 2 * pad_x - kw) // stride + 1
    k = kh * kw * c
    if kh == kw == 1 and stride == 1 and not pad_y and not pad_x \
            and k == kp:
        return xq.contiguous().view(b * h * w, c)
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
    return cols


def _conv(xq, wm, n, kh, kw, stride, pad_y, pad_x, mm) -> torch.Tensor:
    b, h, w, _ = xq.shape
    oh = (h + 2 * pad_y - kh) // stride + 1
    ow = (w + 2 * pad_x - kw) // stride + 1
    cols = _im2col(xq.view(torch.int8), wm.shape[1], kh, kw, stride,
                   pad_y, pad_x)
    y = mm(cols.view(xq.dtype), wm)
    del cols                             # the largest buffer of the conv
    if wm.shape[0] != n:
        y = y[:, :n].contiguous()
    return y.view(b, oh, ow, n)


def conv_int8(xq: torch.Tensor, wm: torch.Tensor, n: int, kh: int,
              kw: int, stride: int, pad_y: int, pad_x: int
              ) -> torch.Tensor:
    """int32 NHWC output (contiguous) of an ungrouped convolution of an
    int8 NHWC ``xq`` with a packed HWIO weight (:func:`pack_weight`),
    zero padding, floor-mode output size."""
    return _conv(xq, wm, n, kh, kw, stride, pad_y, pad_x, _int_mm)


def conv_fp8(xq: torch.Tensor, wm: torch.Tensor, n: int, kh: int,
             kw: int, stride: int, pad_y: int, pad_x: int
             ) -> torch.Tensor:
    """float32 NHWC output (contiguous) of an ungrouped convolution of an
    e4m3 NHWC ``xq`` with a packed e4m3 HWIO weight (:func:`pack_weight`
    with ``dtype = "fp8"``), zero padding, floor-mode output size."""
    return _conv(xq, wm, n, kh, kw, stride, pad_y, pad_x, _fp8_mm)
