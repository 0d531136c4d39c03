"""The port's conv_epilogue against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes the kernel's plain version (the
CUDA kernel runs only on the card, where chip_smoke.py holds it against
the same plain version); the reference runs its Pallas kernel in
interpret mode, as tests/test_pallas.py runs it. Same numpy-seeded
inputs into both.

Tolerances:
- float32 out: rtol 1e-6 (+ atol 1e-6 on O(1) values): both compute
  x*scale + shift in f32, but XLA may contract the multiply-add into
  one FMA where PyTorch rounds twice, so results near zero can differ
  by one rounding of the product.
- bfloat16 out: one bf16 ulp of the reference value, for the same
  reason surfacing through the final round to 8 mantissa bits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers.pallas_kernels import conv_epilogue as jax_epilogue
from cxxnet_tpu_torch.layers import kernels

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits), floored at the
    smallest normal's ulp."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _inputs(shape, in_dtype, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    t = rng.randn(c).astype(np.float32)
    xt = torch.from_numpy(x).to(in_dtype)
    # the reference sees exactly the values the port sees
    xj = jnp.asarray(xt.float().numpy()).astype(_JDT[in_dtype])
    return xt, torch.from_numpy(s), torch.from_numpy(t), xj, s, t


@pytest.mark.parametrize("shape", [(2, 6, 10, 24), (5, 24), (3, 4, 5, 7)],
                         ids=["nhwc", "mat", "nhwc_ragged_c"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=["f32_f32", "f32_bf16", "bf16_bf16", "bf16_f32"])
def test_conv_epilogue_plain_matches_pallas(shape, relu, in_dtype,
                                            out_dtype):
    kernels.reset_launch_counts()
    x, s, t, xj, sj, tj = _inputs(shape, in_dtype, seed=len(shape))
    got = kernels.conv_epilogue(x, s, t, relu, out_dtype)
    ref = np.asarray(jax_epilogue(xj, jnp.asarray(sj), jnp.asarray(tj),
                                  relu, _JDT[out_dtype]).astype(jnp.float32))
    assert got.dtype == out_dtype and tuple(got.shape) == shape
    g = got.float().numpy()
    if out_dtype == torch.float32:
        np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(g - ref) <= _bf16_ulp(ref))
    if relu:
        assert g.min() >= 0.0
    # CPU tensors take the plain version: no kernel launch counted
    assert kernels.conv_epilogue.launches == 0


def test_conv_epilogue_wrapper_equals_plain():
    x, s, t, _, _, _ = _inputs((2, 3, 3, 8), torch.float32, seed=3)
    a = kernels.conv_epilogue(x, s, t, True)
    b = kernels.conv_epilogue_plain(x, s, t, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["int32", "f64", "3d", "scale_shape",
                                  "scale_dtype", "noncontig",
                                  "out_dtype"])
def test_conv_epilogue_wrapper_rejects(case):
    x = torch.zeros(2, 3, 3, 4)
    s, t = torch.ones(4), torch.zeros(4)
    out = torch.float32
    err = ValueError
    if case == "int32":
        # the int32 accumulator has no gradient: a differentiable call
        # on it (scale requiring grad) raises
        x, err = x.to(torch.int32), TypeError
        s = s.requires_grad_(True)
    elif case == "f64":
        x, err = x.double(), TypeError
    elif case == "3d":
        x = torch.zeros(2, 3, 4)
    elif case == "scale_shape":
        s = torch.ones(5)
    elif case == "scale_dtype":
        s = torch.ones(4, dtype=torch.float64)
    elif case == "noncontig":
        x = torch.zeros(2, 4, 3, 3).permute(0, 2, 3, 1)
    elif case == "out_dtype":
        out, err = torch.float16, TypeError
    with pytest.raises(err):
        kernels.conv_epilogue(x, s, t, True, out)


# ------------------------------------------------------------ bn_apply
#
# The reference runs its Pallas bn_apply in interpret mode; the port's
# wrapper takes its plain version on the CPU. Tolerances:
# - forward: rtol 1e-6, atol 1e-6, for the conv_epilogue reason above
#   (XLA may contract x*scale + shift into one FMA);
# - VJP dx: rtol 1e-6 (atol 1e-6, the same contraction of dym*scale+0);
#   dscale/dshift: rtol 1e-5 (atol 1e-5 on O(1) sums), because the f32
#   channel sums add in another order.

from cxxnet_tpu.layers.pallas_kernels import bn_apply as jax_bn_apply  # noqa: E402
from cxxnet_tpu.layers.pallas_kernels import matmul as jax_matmul  # noqa: E402
import jax  # noqa: E402

BN_SHAPES = [(2, 6, 10, 24), (5, 24), (3, 4, 5, 7)]
BN_IDS = ["nhwc", "mat", "nhwc_ragged_c"]


@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_bn_apply_fwd_plain_matches_pallas(shape, relu):
    kernels.reset_launch_counts()
    x, s, t, xj, sj, tj = _inputs(shape, torch.float32, seed=10 + len(shape))
    got = kernels.bn_apply_fwd(x, s, t, relu)
    ref = np.asarray(jax_bn_apply(xj, jnp.asarray(sj), jnp.asarray(tj),
                                  relu))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the autograd entry point computes the same
    assert torch.equal(kernels.bn_apply(x, s, t, relu), got)
    assert kernels.launch_counts()["bn_apply_fwd"] == 0


@pytest.mark.parametrize("shape", BN_SHAPES, ids=BN_IDS)
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_bn_apply_vjp_matches_jax(shape, relu):
    x, s, t, xj, sj, tj = _inputs(shape, torch.float32, seed=20 + len(shape))
    dy = np.random.RandomState(5).randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_bn_apply(a, b, c, relu), xj,
                     jnp.asarray(sj), jnp.asarray(tj))
    jdx, jds, jdt = (np.asarray(v) for v in vjp(jnp.asarray(dy)))
    xa = x.clone().requires_grad_(True)
    sa = s.clone().requires_grad_(True)
    ta = t.clone().requires_grad_(True)
    y = kernels.bn_apply(xa, sa, ta, relu)
    pdx, pds, pdt = torch.autograd.grad(y, (xa, sa, ta),
                                        torch.from_numpy(dy))
    np.testing.assert_allclose(pdx.numpy(), jdx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pds.numpy(), jds, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pdt.numpy(), jdt, rtol=1e-5, atol=1e-5)


def test_bn_apply_bwd_reads_a_channel_slice():
    """The cotangent a channel concat hands back is a slice of a wider
    tensor: the wrapper takes it in place, with its row stride."""
    x, s, t, _, _, _ = _inputs((2, 3, 4, 8), torch.float32, seed=4)
    y = kernels.bn_apply_fwd(x, s, t, True)
    wide = torch.randn(2, 3, 4, 20)
    dy = wide[..., 4:12]
    assert not dy.is_contiguous() and kernels._row_stride(dy) == 20
    got = kernels.bn_apply_bwd(x, y, dy, s, True)
    ref = kernels.bn_apply_bwd_plain(x, y, dy.contiguous(), s, True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert kernels._row_stride(wide.permute(0, 2, 1, 3)) is None


@pytest.mark.parametrize("case", ["bf16", "f64", "3d", "scale_shape",
                                  "noncontig", "dy_shape", "no_y"])
def test_bn_apply_wrappers_reject(case):
    x = torch.zeros(2, 3, 3, 4)
    s, t = torch.ones(4), torch.zeros(4)
    dy, y = torch.zeros(2, 3, 3, 4), torch.zeros(2, 3, 3, 4)
    err, fn = ValueError, "fwd"
    if case == "bf16":
        # bf16 activations take float32 scale and shift, not bf16 ones
        x, s = x.bfloat16(), s.bfloat16()
    elif case == "f64":
        x, err = x.double(), TypeError
    elif case == "3d":
        x = torch.zeros(2, 3, 4)
    elif case == "scale_shape":
        s = torch.ones(5)
    elif case == "noncontig":
        x = torch.zeros(2, 4, 3, 3).permute(0, 2, 3, 1)
    elif case == "dy_shape":
        dy, fn = torch.zeros(2, 3, 3, 5), "bwd"
    elif case == "no_y":
        y, fn = None, "bwd"
    with pytest.raises(err):
        if fn == "fwd":
            kernels.bn_apply_fwd(x, s, t, True)
        else:
            kernels.bn_apply_bwd(x, y, dy, s, True)


# -------------------------------------------------------------- matmul
#
# Tolerance rtol 1e-5, atol 1e-5 * sqrt(K): the same f32 products,
# summed in another order (oneDNN here, the Pallas kernel in interpret
# mode there).

MM_SHAPES = [(8, 24, 16), (5, 37, 3), (1, 9, 130)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES, ids=["even", "ragged", "row"])
def test_matmul_and_vjp_match_jax(m, k, n):
    kernels.reset_launch_counts()
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    dy = rng.randn(m, n).astype(np.float32)
    jy, vjp = jax.vjp(jax_matmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(v) for v in vjp(jnp.asarray(dy)))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = kernels.matmul(xt, wt)
    pdx, pdw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    for got, ref, depth in ((y.detach(), jy, k), (pdx, jdx, n),
                            (pdw, jdw, m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * np.sqrt(depth))
    assert kernels.launch_counts()["matmul"] == 0


def test_matmul_kernel_takes_transposed_views():
    a = torch.randn(6, 4)
    b = torch.randn(5, 4)
    assert kernels._mat_strides(b.t()) == (1, 4)
    assert torch.equal(kernels.matmul_kernel(a, b.t()),
                       kernels.matmul_plain(a, b.t()))
    with pytest.raises(ValueError):
        kernels.matmul_kernel(a, torch.randn(5, 3))
    with pytest.raises(ValueError):
        kernels.matmul_kernel(a, torch.randn(4, 5, 2)[:, :, 0])
    # bf16 operands are read in place too, through their strides, with
    # a float32 output (tests/test_torch_port_bf16.py holds them to the
    # reference)
    got = kernels.matmul_kernel(a.bfloat16(), b.t().bfloat16())
    assert got.dtype == torch.float32
    assert torch.equal(got, kernels.matmul_plain(a.bfloat16(),
                                                 b.bfloat16().t()))
    with pytest.raises(ValueError):
        kernels.matmul_kernel(a.half(), b.t())


# ------------------------------------------------- the two host plans
#
# matmul_plan and bn_bwd_plan decide, in Python, how csrc/matmul.cu and
# the bn_apply backward launch; the card runs what they say. Checked
# here at the main path's shapes (Inception-BN-224 at batch 128), with
# the H100's 132 SMs.

FC1 = (128, 1024, 1000)           # batch, fc1's input, 1000 classes
# (m, k, n, strides, dtypes) of fc1's three products: x.w, dy.w^T
# (w^T a k-contiguous view) and x^T.dy (x^T m-contiguous)
FC1_PRODUCTS = {
    "forward": (128, 1024, 1000, ((1024, 1), (1000, 1))),
    "dy_wT": (128, 1000, 1024, ((1000, 1), (1, 1000))),
    "xT_dy": (1024, 128, 1000, ((1, 1024), (1000, 1))),
}
F32, BF16 = "float32", "bfloat16"


def test_matmul_plan_takes_the_tensor_cores_for_fc1_bf16_forward():
    m, k, n, st = FC1_PRODUCTS["forward"]
    plan = kernels.matmul_plan(m, k, n, st, (torch.bfloat16,
                                             torch.bfloat16))
    assert plan["route"] == "wgmma"
    # ragged M and N stay on the tensor cores: TMA fills the edges
    assert kernels.matmul_plan(77, 1000, 136, ((1000, 1), (136, 1)),
                               (BF16, BF16))["route"] == "wgmma"


@pytest.mark.parametrize("case", [
    ("forward", (F32, F32)), ("dy_wT", (F32, F32)), ("xT_dy", (F32, F32)),
    ("dy_wT", (F32, BF16)), ("xT_dy", (BF16, F32)),
    # bf16 . bf16 that TMA cannot read: B k-contiguous, A m-contiguous
    ("dy_wT", (BF16, BF16)), ("xT_dy", (BF16, BF16))],
    ids=lambda c: "%s-%s" % (c[0], "x".join(c[1])))
def test_matmul_plan_takes_the_fma_route(case):
    name, dtypes = case
    m, k, n, st = FC1_PRODUCTS[name]
    assert kernels.matmul_plan(m, k, n, st, dtypes)["route"] == "fma"


@pytest.mark.parametrize("why", ["row_stride", "a_row_stride", "base"])
def test_matmul_plan_sends_tma_misaligned_bf16_to_fma(why):
    """TMA needs row strides of whole 16 bytes and 16-byte-aligned
    bases: a 129-wide bf16 B (258-byte rows), a 1001-wide A, or a base
    off the 16-byte grid take the FMA route."""
    if why == "row_stride":
        args = (77, 1000, 129, ((1000, 1), (129, 1)))
    elif why == "a_row_stride":
        args = (77, 1001, 128, ((1001, 1), (128, 1)))
    else:
        args = FC1_PRODUCTS["forward"]
    plan = kernels.matmul_plan(*args, (BF16, BF16), aligned=why != "base")
    assert plan["route"] == "fma"


@pytest.mark.parametrize("dtypes", [(F32, F32), (BF16, BF16)],
                         ids=["f32", "bench_set"])
def test_matmul_plan_splits_fill_the_card(dtypes):
    """fc1's forward and dy.w^T, 16 or 32 output tiles alone, split K
    so that each launches at least 120 blocks; every product's cluster
    stays within the portable 8 CTAs."""
    for name in ("forward", "dy_wT"):
        m, k, n, st = FC1_PRODUCTS[name]
        dts = dtypes if name == "forward" else (F32, dtypes[1])
        plan = kernels.matmul_plan(m, k, n, st, dts)
        tm, tn, _ = plan["tile"]
        assert plan["blocks"] == -(-m // tm) * -(-n // tn) * plan["splits"]
        assert plan["blocks"] >= 120, (name, plan)
    for m in (1, 4, 77, 128, 1024, 4096):
        for k in (1, 16, 1000, 1024, 9216):
            for n in (1, 10, 129, 1000):
                for dts in ((F32, F32), (BF16, BF16), (F32, BF16)):
                    plan = kernels.matmul_plan(m, k, n, ((k, 1), (n, 1)),
                                               dts)
                    assert 1 <= plan["splits"] <= 8, (m, k, n, plan)


def _inception224_bn_shapes():
    """(rows, C) of each of Inception-BN-224's 69 batch norms in the
    batch-128 training step (shapes only)."""
    from cxxnet_tpu_torch.graph import NetGraph
    from cxxnet_tpu_torch.models import inception_bn
    from cxxnet_tpu_torch.nnet.net import FuncNet
    from cxxnet_tpu_torch.utils.config import parse_config
    g = NetGraph()
    g.configure(parse_config(inception_bn(nclass=1000, batch_size=128,
                                          image_size=224))
                + [("bn_pallas", "1"), ("bn_fuse_relu", "1")])
    net = FuncNet(g, 128)
    shapes = []
    for li, info in enumerate(g.layers):
        if info.type in ("batch_norm", "pallas_batch_norm"):
            s = net.layer_objs[li].out_shapes[0]
            shapes.append((128 * s.y * s.x, s.ch))
    return shapes


@pytest.mark.parametrize("dtype,v", [(F32, 4), (BF16, 8)],
                         ids=["f32", "bf16"])
def test_bn_bwd_plan_at_every_inception_bn_shape(dtype, v):
    """At every batch norm of the batch-128 step: 16-byte vectors (V = 8
    bf16, V = 4 float32 channels), every thread of a block owning a
    (row group, channel vector) pair (whole warps wherever a multiple
    of the channel vectors that is one fits in 256 threads: 352
    channels, 44 or 88 vectors, take 220 threads, none idle), and the
    f32 partial rows' traffic within 5 % of the layer's bytes."""
    shapes = _inception224_bn_shapes()
    assert len(shapes) == 69
    for rows, c in shapes:
        plan = kernels.bn_bwd_plan(rows, c, c, (dtype, dtype))
        assert plan["v"] == v, (rows, c, plan)
        assert plan["tiles"] * plan["ct"] == plan["nv"] == c // v
        assert plan["threads"] == plan["ct"] * plan["rpi"] <= 256
        whole = 32 // math.gcd(plan["ct"], 32) * plan["ct"] <= 256
        assert plan["threads"] % 32 == 0 or not whole, (rows, c, plan)
        assert plan["part_bytes"] <= 0.05 * plan["layer_bytes"], (rows, c)
        # a block for about every SM (whole rows a block may leave one
        # short: 6272 rows make 131 blocks of 48)
        assert plan["blocks"] >= 130, (rows, c, plan)
        assert plan["group"] * plan["ngroups"] >= plan["nbx"]
        assert plan["part_floats"] == 2 * c * (plan["nbx"]
                                               + plan["ngroups"])


def test_bn_bwd_plan_keeps_the_scalar_path_for_the_rest():
    """A channel count, row stride or base off the vector grid takes
    narrower vectors: bf16 C = 36 (not a multiple of 8) V = 4; C = 67
    or a misaligned base V = 1; conv_epilogue's mixed (x, y) dtypes V =
    4."""
    assert kernels.bn_bwd_plan(1000, 36, 36, (BF16, BF16))["v"] == 4
    assert kernels.bn_bwd_plan(1000, 67, 67, (F32, F32))["v"] == 1
    assert kernels.bn_bwd_plan(1000, 64, 67, (F32, F32))["v"] == 1
    assert kernels.bn_bwd_plan(1000, 64, 64, (BF16, BF16),
                               aligned=False)["v"] == 1
    assert kernels.bn_bwd_plan(1000, 64, 64, (F32, BF16))["v"] == 4
    tiny = kernels.bn_bwd_plan(3, 8, 8, (F32, F32))
    assert tiny["nbx"] == 1 and tiny["part_floats"] == 0


# ------------------------------------------------------- relu_max_pool
#
# The reference runs its Pallas relu_max_pool in interpret mode; the
# port's wrapper takes its plain version on the CPU. Tolerances: the
# forward is exact (maxima of the same values); the backward (jax.grad
# of sum(y²)) within atol 1e-6 (the f32 sums of tied windows add the
# same terms in the same order, XLA may fuse 2*y*... differently), and
# exact on the 0.5-grid tie case; against the reference's H-chunked
# path, whose overlapping halos add partial sums, within atol 1e-5.

import torch.nn.functional as F  # noqa: E402
from cxxnet_tpu.layers import pallas_kernels as jax_pk  # noqa: E402

POOL_CASES = [((2, 9, 9, 8), 3, False), ((3, 12, 10, 16), 3, False),
              ((2, 7, 7, 8), 2, False), ((2, 9, 11, 8), 3, True)]
POOL_IDS = ["9x9_k3", "12x10_k3", "7x7_k2", "ties_k3"]


def _pool_input(shape, ties, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if ties:
        # steps of 0.5: positive windows hold tied maxima
        x = (np.round(x * 2) / 2).astype(np.float32)
    return x


def _port_pool_grad(x, k):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = kernels.relu_max_pool(xt, k)
    (g,) = torch.autograd.grad((y ** 2).sum(), [xt])
    return y.detach().numpy(), g.numpy()


@pytest.mark.parametrize("shape,k,ties", POOL_CASES, ids=POOL_IDS)
def test_relu_max_pool_matches_pallas(shape, k, ties):
    kernels.reset_launch_counts()
    x = _pool_input(shape, ties, seed=sum(shape) + k)
    y, g = _port_pool_grad(x, k)
    jy = np.asarray(jax_pk.relu_max_pool(jnp.asarray(x), k))
    jg = np.asarray(jax.grad(
        lambda a: jnp.sum(jax_pk.relu_max_pool(a, k) ** 2))(jnp.asarray(x)))
    assert y.shape == (shape[0], shape[1] - k + 1, shape[2] - k + 1,
                       shape[3])
    np.testing.assert_array_equal(y, jy)
    if ties:
        np.testing.assert_array_equal(g, jg)
    else:
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    assert kernels.launch_counts()["relu_max_pool_fwd"] == 0
    assert kernels.launch_counts()["relu_max_pool_bwd"] == 0


def test_relu_max_pool_matches_pallas_chunked(monkeypatch):
    """The reference's H-chunked halo path (its stems chunk) against the
    port's one-pass plain versions."""
    monkeypatch.setattr(jax_pk, "_chunk_rows", lambda *a, **kw: 8)
    x = _pool_input((2, 30, 13, 8), True, seed=30)
    y, g = _port_pool_grad(x, 3)
    jy = np.asarray(jax_pk.relu_max_pool(jnp.asarray(x), 3))
    jg = np.asarray(jax.grad(
        lambda a: jnp.sum(jax_pk.relu_max_pool(a, 3) ** 2))(jnp.asarray(x)))
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5)


def test_relu_max_pool_credits_every_tie():
    """On a 0.5 grid the kernel's backward credits every tied maximum,
    where F.max_pool2d's autograd credits one per window: the two must
    differ, and the sum of the kernel's dx over a window's ties is the
    tie count times dy."""
    x = torch.zeros(1, 3, 3, 1)
    x[0, 0, 0, 0] = x[0, 2, 2, 0] = 1.5
    dy = torch.ones(1, 1, 1, 1)
    y = kernels.relu_max_pool_fwd(x, 3)
    dx = kernels.relu_max_pool_bwd(x, y, dy, 3)
    assert float(y) == 1.5
    assert dx[0, 0, 0, 0] == 1.0 and dx[0, 2, 2, 0] == 1.0
    assert float(dx.sum()) == 2.0
    xt = x.clone().requires_grad_(True)
    yt = F.max_pool2d(torch.relu(xt).permute(0, 3, 1, 2), 3, 1)
    (g,) = torch.autograd.grad(yt.sum(), [xt])
    assert float(g.sum()) == 1.0 and not torch.equal(g, dx)
    xg = _pool_input((2, 9, 11, 8), True, seed=3)
    _, gk = _port_pool_grad(xg, 3)
    xt = torch.from_numpy(xg).requires_grad_(True)
    yt = F.max_pool2d(torch.relu(xt).permute(0, 3, 1, 2), 3, 1)
    (g1,) = torch.autograd.grad((yt ** 2).sum(), [xt])
    assert not np.array_equal(gk, g1.numpy())


def test_relu_max_pool_bwd_reads_strided_dy():
    """The cotangent may be a permuted or an expanded view: the wrapper
    takes it as it is, and the result equals the dense one's."""
    x = torch.from_numpy(_pool_input((2, 8, 7, 4), True, seed=5))
    y = kernels.relu_max_pool_fwd(x, 3)
    dy = torch.randn(2, 4, 6, 5).permute(0, 2, 3, 1)
    assert not dy.is_contiguous()
    dx = kernels.relu_max_pool_bwd(x, y, dy, 3)
    assert torch.equal(dx, kernels.relu_max_pool_bwd_plain(
        x, y, dy.contiguous(), 3))
    ones = torch.ones(()).expand(y.shape)
    assert torch.equal(kernels.relu_max_pool_bwd(x, y, ones, 3),
                       kernels.relu_max_pool_bwd_plain(
                           x, y, torch.ones(y.shape), 3))


def test_relu_max_pool_propagates_nan():
    """NaN in a window makes its maximum NaN (torch.maximum, as
    jnp.maximum), and a NaN input gets no gradient."""
    x = torch.from_numpy(_pool_input((1, 5, 5, 3), False, seed=6))
    x[0, 2, 2, 1] = float("nan")
    y = kernels.relu_max_pool_fwd(x, 3)
    assert torch.isnan(y[..., 1]).all() and not torch.isnan(y[..., 0]).any()
    jy = np.asarray(jax_pk.relu_max_pool(jnp.asarray(x.numpy()), 3))
    np.testing.assert_array_equal(y.numpy(), jy)
    dx = kernels.relu_max_pool_bwd(x, y, torch.ones(y.shape), 3)
    assert dx[0, 2, 2, 1] == 0 and not torch.isnan(dx).any()


@pytest.mark.parametrize("case", ["bf16", "f64", "3d", "window", "noncontig",
                                  "y_shape", "dy_dtype"])
def test_relu_max_pool_wrappers_reject(case):
    x = torch.zeros(2, 5, 5, 4)
    y, dy = torch.zeros(2, 3, 3, 4), torch.zeros(2, 3, 3, 4)
    k, err, fn = 3, ValueError, "fwd"
    if case == "bf16":
        # a bf16 input's output and cotangent must be bf16 as well
        x, fn = x.bfloat16(), "bwd"
    elif case == "f64":
        x, err = x.double(), TypeError
    elif case == "3d":
        x = torch.zeros(2, 5, 4)
    elif case == "window":
        k = 6
    elif case == "noncontig":
        x = torch.zeros(2, 4, 5, 5).permute(0, 2, 3, 1)
    elif case == "y_shape":
        y, fn = torch.zeros(2, 4, 3, 4), "bwd"
    elif case == "dy_dtype":
        dy, fn = dy.double(), "bwd"
    with pytest.raises(err):
        if fn == "fwd":
            kernels.relu_max_pool_fwd(x, k)
        else:
            kernels.relu_max_pool_bwd(x, y, dy, k)
