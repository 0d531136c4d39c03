"""The port's bf16 avg pool forward against the reference's, bit for bit.

The reference's avg pool (``cxxnet_tpu/layers/conv.py``,
``PoolingLayer._pool``) is ``reduce_window`` add in bf16, one rounding
per add, times ``1 / (kh * kw)``; XLA:CPU picks the order of the adds.
The port's ``PoolingLayer._bf16_window_sum`` adds the window slices in the
order :func:`cxxnet_tpu_torch.layers.conv.xla_window_sum_order` gives:
row-major, or the last window column added last when XLA peels it off
(every k = 2 pool with a pad or an overhang, and every pad-0 pool whose
overhang is one column). The reference is compiled with
``xla_allow_excess_precision`` off, as ``test_torch_port_bf16.py``
compiles its steps, or XLA keeps f32 inside the fusion.

``test_bf16_avg_pool_forward_matches_reference_bits`` holds named
cases of every class where the order is not row-major, the classes
where it is, and the avg pools of the repo's models.
``test_xla_window_sum_order_over_grid`` holds the rule over two grids
of configurations that the layer accepts: square windows, k 2-5,
stride 1-3, pad 0-2 (pad < k), h = w 7-11 (165); and windows with kh
!= kw or pad_y != pad_x, kh and kw 2-4, stride 1-3, each pad 0-2 below
its side, on 7x9 and 9x8 inputs (336). At each the rule's order gives
the reference's bits, and row-major gives them exactly where the rule
says row-major.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers import Shape3 as JShape3
from cxxnet_tpu.layers import create_layer as jax_create
from cxxnet_tpu_torch.layers import Shape3, create_layer
from cxxnet_tpu_torch.layers.conv import xla_window_sum_order

NO_EXCESS = {"xla_allow_excess_precision": False}


def _f32(t):
    return t.detach().float().numpy()


def _cfg(k, stride, pad):
    return [("kernel_size", str(k)), ("stride", str(stride)),
            ("pad", str(pad))]


def _rect_cfg(kh, kw, stride, py, px):
    return [("kernel_height", str(kh)), ("kernel_width", str(kw)),
            ("stride", str(stride)), ("pad_y", str(py)), ("pad_x", str(px))]


def _reference(layers, xs):
    """The reference layers' ``_pool`` of each bf16 input, one compile."""
    def f(*vs):
        return tuple(j._pool(v) for j, v in zip(layers, vs))
    compiled = jax.jit(f).lower(
        *[jax.ShapeDtypeStruct(x.shape, jnp.bfloat16) for x in xs]) \
        .compile(compiler_options=NO_EXCESS)
    outs = compiled(*[jnp.asarray(_f32(x)).astype(jnp.bfloat16)
                      for x in xs])
    return [np.asarray(o, np.float32) for o in outs]


def _pair_cfg(cfg, ch, h, w):
    j, p = jax_create("avg_pooling", cfg), create_layer("avg_pooling", cfg)
    (js,) = j.infer_shape([JShape3(ch, h, w)])
    (ps,) = p.infer_shape([Shape3(ch, h, w)])
    assert tuple(js) == tuple(ps)
    return j, p


def _pair(k, stride, pad, ch, h, w):
    return _pair_cfg(_cfg(k, stride, pad), ch, h, w)


# (k, stride, pad, (C, H, W)); the scan's failing classes first
CASES = {
    # k = 2 with a pad: every one adds column 0, then column 1
    "k2_s1_p1_h7": (2, 1, 1, (4, 7, 7)),
    "k2_s2_p1_h8": (2, 2, 1, (4, 8, 8)),
    "k2_s3_p1_h9": (2, 3, 1, (4, 9, 9)),
    # k = 2 at pad 0: an overhang peels, a fit does not
    "k2_s2_p0_h9_overhang": (2, 2, 0, (4, 9, 9)),
    "k2_s3_p0_h10_overhang": (2, 3, 0, (4, 10, 10)),
    "k2_s2_p0_h8_fit": (2, 2, 0, (4, 8, 8)),
    "k2_s1_p0_h7_fit": (2, 1, 0, (4, 7, 7)),
    # k = 3-5 at pad 0: an overhang of one column peels
    "k3_s2_p0_h8_overhang": (3, 2, 0, (4, 8, 8)),
    "k3_s2_p0_h10_overhang": (3, 2, 0, (6, 10, 10)),
    "k4_s2_p0_h11_overhang": (4, 2, 0, (4, 11, 11)),
    "k5_s2_p0_h8_overhang": (5, 2, 0, (4, 8, 8)),
    # an overhang of two columns: still row-major
    "k4_s3_p0_h8_overhang2": (4, 3, 0, (4, 8, 8)),
    "k3_s3_p0_h7_overhang2": (3, 3, 0, (4, 7, 7)),
    "k3_s2_p0_h9_fit": (3, 2, 0, (4, 9, 9)),
    "k5_s3_p0_h11_fit": (5, 3, 0, (4, 11, 11)),
    # k = 3 with a pad: row-major
    "k3_s1_p1_h7": (3, 1, 1, (4, 7, 7)),
    "k3_s2_p1_h8": (3, 2, 1, (4, 8, 8)),
    "k3_s1_p2_h9": (3, 1, 2, (4, 9, 9)),
    "k3_s3_p2_h10": (3, 3, 2, (4, 10, 10)),
    "k4_s2_p1_h9": (4, 2, 1, (4, 9, 9)),
    # height and width apart: the columns decide
    "k2_s2_p0_h8_w9": (2, 2, 0, (4, 8, 9)),
    "k3_s2_p0_h9_w8": (3, 2, 0, (4, 9, 8)),
    # the models' avg pools: Inception-BN's 3x3 s1 p1 at 56, 28 and
    # 14 px and its 7x7 global pool, the tower's 14 px pool and the
    # tiny net's 4x4 global pool
    "inception_3x3_s1_p1_56": (3, 1, 1, (8, 56, 56)),
    "inception_3x3_s1_p1_28": (3, 1, 1, (8, 28, 28)),
    "inception_3x3_s1_p1_14": (3, 1, 1, (8, 14, 14)),
    "inception_global_7": (7, 1, 0, (8, 7, 7)),
    "tiny_global_4": (4, 1, 0, (8, 4, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_avg_pool_forward_matches_reference_bits(case):
    """The port's bf16 ``avg_pooling`` forward against the reference's
    ``PoolingLayer._pool``: the same bits at batch 2."""
    k, stride, pad, (ch, h, w) = CASES[case]
    j, p = _pair(k, stride, pad, ch, h, w)
    rng = np.random.RandomState(list(CASES).index(case))
    x = torch.from_numpy(rng.randn(2, h, w, ch).astype(np.float32)) \
        .to(torch.bfloat16)
    (ref,) = _reference([j], [x])
    (y,), _ = p.forward({}, {}, [x])
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == ref.shape
    np.testing.assert_array_equal(_f32(y), ref)


def test_bf16_avg_pool_sums_from_plus_zero():
    """``reduce_window`` starts each window's sum at its init, +0, so a
    window of -0 inputs averages to +0 in the reference; the port adds
    from +0 too (the same bits, signs of zero included)."""
    j, p = _pair(3, 1, 1, 2, 5, 5)
    x = torch.full((1, 5, 5, 2), -0.0, dtype=torch.bfloat16)
    x[0, 0, 0, 1] = 1.0
    (ref,) = _reference([j], [x])
    (y,), _ = p.forward({}, {}, [x])
    assert not np.signbit(ref).any()
    np.testing.assert_array_equal(_f32(y).view(np.uint32),
                                  ref.view(np.uint32))


def _square_grid():
    """(kh, kw, stride, pad_y, pad_x, h, w): k 2-5, stride 1-3, pad 0-2
    below k, h = w 7-11."""
    for k in range(2, 6):
        for stride in range(1, 4):
            for pad in range(min(k, 3)):
                for h in range(7, 12):
                    yield k, k, stride, pad, pad, h, h


def _rect_grid():
    """(kh, kw, stride, pad_y, pad_x, h, w): kh and kw 2-4 with kh !=
    kw or pad_y != pad_x, stride 1-3, each pad 0-2 below its side, on
    7x9 and 9x8 inputs."""
    for kh in range(2, 5):
        for kw in range(2, 5):
            for stride in range(1, 4):
                for py in range(min(kh, 3)):
                    for px in range(min(kw, 3)):
                        if kh == kw and py == px:
                            continue
                        for h, w in ((7, 9), (9, 8)):
                            yield kh, kw, stride, py, px, h, w


def _window_sum(x, kh, kw, stride, oy, ox, order):
    """bf16 window sums of the padded ``x`` in ``order``, times the bf16
    ``1 / (kh * kw)``: the port's arithmetic with the order given."""
    y = None
    for di, dj in order:
        v = x[:, di:di + (oy - 1) * stride + 1:stride,
              dj:dj + (ox - 1) * stride + 1:stride]
        y = v if y is None else y + v
    return y * float(torch.tensor(1.0 / (kh * kw), dtype=torch.bfloat16))


# grid, configurations the layer accepts, of them peeled
GRIDS = {"square": (_square_grid, 165, 32),
         "rectangular_or_unequal_pads": (_rect_grid, 336, 77)}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_xla_window_sum_order_over_grid(grid):
    """At every configuration of the grid that the layer accepts, the
    rule's order gives the reference's bits, and row-major gives them
    exactly where the rule says row-major."""
    configs, n_accepted, n_peeled = GRIDS[grid]
    cases = []
    for kh, kw, stride, py, px, h, w in configs():
        try:
            j, p = _pair_cfg(_rect_cfg(kh, kw, stride, py, px), 4, h, w)
        except ValueError:
            continue
        cases.append((kh, kw, stride, py, px, h, w, j, p))
    assert len(cases) == n_accepted
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(2, c[5], c[6], 4).astype(np.float32))
          .to(torch.bfloat16) for c in cases]
    refs = _reference([c[7] for c in cases], xs)
    peeled = 0
    for (kh, kw, stride, py, px, h, w, _, p), x, ref in zip(cases, xs, refs):
        oy, ox = p.out_shapes[0].y, p.out_shapes[0].x
        ey = max(0, (oy - 1) * stride + kh - (h + 2 * py))
        ex = max(0, (ox - 1) * stride + kw - (w + 2 * px))
        xp = torch.nn.functional.pad(x, (0, 0, px, px + ex, py, py + ey))
        order = xla_window_sum_order(kh, kw, stride, px, w, ox)
        row_major = [(di, dj) for di in range(kh) for dj in range(kw)]
        what = "kh%d kw%d s%d py%d px%d h%d w%d" % (kh, kw, stride, py, px,
                                                   h, w)
        np.testing.assert_array_equal(
            _f32(_window_sum(xp, kh, kw, stride, oy, ox, order)), ref,
            err_msg=what)
        rm_equal = np.array_equal(
            _f32(_window_sum(xp, kh, kw, stride, oy, ox, row_major)), ref)
        assert rm_equal == (order == row_major), what
        peeled += order != row_major
    assert peeled == n_peeled


def test_xla_window_sum_order_cases():
    """The rule's two orders at a peeled and a row-major pool."""
    assert xla_window_sum_order(2, 2, 1, 1, 7, 8) == [
        (0, 0), (1, 0), (0, 1), (1, 1)]
    assert xla_window_sum_order(3, 3, 2, 0, 10, 5) == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1),
        (0, 2), (1, 2), (2, 2)]
    assert xla_window_sum_order(3, 3, 1, 1, 7, 7) == [
        (di, dj) for di in range(3) for dj in range(3)]
