"""Two bf16 gradients of the port against the JAX package.

**conv_epilogue's VJP with a bf16 input or output**
(``cxxnet_tpu/layers/pallas_kernels.py:388-398``): ``dym = dy * [y >
0]`` in y's dtype, ``dx`` the f32 epilogue of dym with shift 0 rounded
once to x's dtype (``+ 0`` turns -0 into +0), ``dscale = sum f32(dym) *
f32(x)``, ``dshift = sum f32(dym)``. The port's autograd Function on
the CPU (the plain version of ``cxn_conv_epilogue_bwd``) against
``jax.vjp`` of the reference's ``conv_epilogue`` (interpret mode) for
(x, y) in {(bf16, bf16), (f32, bf16), (bf16, f32)}: dx the same bits,
the f32 sums within 1e-6 of the sum of their terms' magnitudes (another
summation order).

**The bias gradient under ``dtype = bfloat16``.** The reference adds
``bias.astype(bf16)`` to a bf16 conv or fullc output, so the bias's
gradient is XLA's reduce of the bf16 cotangent, which XLA:CPU rewrites
into a tree of reduce-windows of 32 (``kernels.xla_bias_sum_plan``,
read from the optimized HLO) with a bf16 rounding per add. The port's
``bias_add`` Function sums in that order: the same bits at every shape
below, which cover the probe map 4x50x50x16, an even and two odd pads
(the low side takes floor(pad / 2)), a map with no dim above 32 (no
rewrite), 2-D fullc biases, and a dim that needs two window passes.
(A float32 sum rounded once, which PyTorch's autograd takes, differs at
every one of the 4-D shapes.) The reference is compiled with
``xla_allow_excess_precision`` off, as ``test_torch_port_bf16.py``
compiles its steps; with it on its sums were the same bits at these
shapes.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.layers import pallas_kernels as jax_pk
from cxxnet_tpu_torch.layers import kernels

NO_EXCESS = {"xla_allow_excess_precision": False}
SUM_RTOL = 1e-6


def _f32(t):
    return t.detach().float().numpy()


# ------------------------------------------------- conv_epilogue's VJP

PAIRS = [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
         ("bfloat16", "float32")]


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("xd,yd", PAIRS,
                         ids=["x_%s-y_%s" % p for p in PAIRS])
def test_conv_epilogue_bf16_vjp_matches_reference(xd, yd, relu):
    rng = np.random.RandomState(len(xd) + 3 * len(yd) + relu)
    shape = (2, 5, 4, 12)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
        .to(getattr(torch, xd))
    # exact zeros and negative zeros in dy: the + 0 of dx shows
    dyn = np.round(4 * rng.randn(*shape)).astype(np.float32) / 4
    dyn[..., :2] = -0.0
    dy = torch.from_numpy(dyn).to(getattr(torch, yd))
    scale = torch.from_numpy(rng.rand(12).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(12).astype(np.float32))
    jx = jnp.asarray(_f32(x)).astype(xd)
    jdy = jnp.asarray(_f32(dy)).astype(yd)
    jy, vjp = jax.vjp(lambda a, s, t: jax_pk.conv_epilogue(
        a, s, t, relu, jnp.dtype(yd)), jx, jnp.asarray(scale.numpy()),
        jnp.asarray(shift.numpy()))
    jdx, jds, jdt = vjp(jdy)
    leaves = [v.clone().requires_grad_(True) for v in (x, scale, shift)]
    y = kernels.conv_epilogue(*leaves, relu, getattr(torch, yd))
    dx, ds, dt = torch.autograd.grad(y, leaves, dy)
    # the forward: XLA fuses the reference's f32 multiply-add (one
    # rounding), PyTorch rounds the product and the sum, so an f32 y may
    # lie an ulp of the product away; a bf16 y rounds both the same
    jyf = np.asarray(jy, np.float32)
    if yd == "float32":
        prod = np.abs(_f32(x) * scale.numpy()) + np.abs(shift.numpy())
        assert np.all(np.abs(_f32(y) - jyf) <= 2.0 ** -23 * prod)
    else:
        np.testing.assert_array_equal(_f32(y), jyf)
    assert dx.dtype == x.dtype and ds.dtype == dt.dtype == torch.float32
    # the same bits: -0 and +0 apart
    got = _f32(dx)
    want = np.asarray(jdx, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    dym = np.where(_f32(y) > 0, _f32(dy), 0.0) if relu else _f32(dy)
    axes = (0, 1, 2)
    for g, j, mag in ((ds, jds, np.abs(dym * _f32(x)).sum(axes)),
                      (dt, jdt, np.abs(dym).sum(axes))):
        assert np.all(np.abs(_f32(g) - np.asarray(j)) <= SUM_RTOL * mag)
    # on the CPU the Function takes its plain version: no launch
    assert kernels.launch_counts()["conv_epilogue_bwd_bf16"] == 0


def test_conv_epilogue_bwd_takes_the_bn_apply_backward_at_float32():
    """float32 x and y stay with the bn_apply backward (row 5b's f32
    path); the bf16 entry refuses them."""
    x = torch.randn(2, 3, 3, 4)
    with pytest.raises(TypeError, match="bn_apply"):
        kernels.conv_epilogue_bwd(x, x, x, torch.ones(4), True)


# ------------------------------------------------------- bias gradient

SHAPES = [(4, 50, 50, 16),      # the probe: 50 -> 64, pad 7 / 7
          (4, 101, 101, 8),     # kaiming-tiny's stem: pad 13 / 14
          (4, 33, 33, 16),      # pad 15 / 16
          (4, 16, 16, 32),      # no dim above 32: one sequential sum
          (4, 64),              # a 2-D fullc bias
          (1000, 3),            # 2-D, pad 12 / 12
          (40000, 3)]           # 40000 -> 1250 -> 40 -> 2: three passes


def _reference_bias_vjp(shape):
    """The reference's bias VJP for a bf16 output of ``shape``, compiled
    for a bf16 cotangent (nothing is run)."""
    def f(dy):
        _, vjp = jax.vjp(lambda b: jnp.zeros(shape, jnp.bfloat16)
                         + b.astype(jnp.bfloat16),
                         jnp.zeros((shape[-1],), jnp.float32))
        return vjp(dy)[0]
    return jax.jit(f).lower(jax.ShapeDtypeStruct(shape, jnp.bfloat16)) \
        .compile(compiler_options=NO_EXCESS)


def _reference_bias_grad(dy_f32: np.ndarray) -> np.ndarray:
    c = _reference_bias_vjp(dy_f32.shape)
    return np.asarray(c(jnp.asarray(dy_f32).astype(jnp.bfloat16)))


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_bf16_bias_grad_matches_reference_bits(shape):
    rng = np.random.RandomState(sum(shape))
    dy = torch.from_numpy(3 * rng.randn(*shape).astype(np.float32)) \
        .to(torch.bfloat16)
    want = _reference_bias_grad(_f32(dy))
    np.testing.assert_array_equal(kernels.bias_grad_bf16_plain(dy).numpy(),
                                  want)
    # through the layers' bias add: y and the f32 master's gradient
    y = torch.zeros(shape, dtype=torch.bfloat16, requires_grad=True)
    bias = torch.zeros(shape[-1], requires_grad=True)
    out = kernels.bias_add(y, bias)
    gy, gb = torch.autograd.grad(out, [y, bias], dy)
    assert gb.dtype == torch.float32
    np.testing.assert_array_equal(gb.numpy(), want)
    assert torch.equal(gy, dy)
    if len(shape) == 4:
        f32_sum = dy.float().sum((0, 1, 2)).to(torch.bfloat16).float()
        assert not np.array_equal(f32_sum.numpy(), want)


_REDUCE_WINDOW = re.compile(
    r"= f32\[([\d,]+)\]\S* reduce-window\(.*window=\{size=(\S+) "
    r"stride=[^ }]+(?: pad=(\S+))?\}")


def _hlo_reduce_windows(shape):
    """Each reduce-window pass of the reference's compiled bias VJP at
    ``shape``, per reduced dim ``(windows, window size, low pad)``,
    largest input first."""
    passes = []
    for line in _reference_bias_vjp(shape).as_text().splitlines():
        m = _REDUCE_WINDOW.search(line)
        if m is None:
            continue
        outs = [int(v) for v in m.group(1).split(",")][:-1]
        sizes = [int(v) for v in m.group(2).split("x")][:-1]
        # no pad attribute: no pad
        pads = (m.group(3) or "x".join(["0_0"] * (len(outs) + 1))).split("x")
        lows = [int(v.split("_")[0]) for v in pads][:-1]
        passes.append(tuple(zip(outs, sizes, lows)))
    return sorted(set(passes), key=lambda p: -int(np.prod([n for n, _, _
                                                            in p])))


def _kaiming224_bias_shapes():
    """The output shape of every conv and fullc bias of kaiming-224's
    bf16 training step at batch 128 (shapes only)."""
    from cxxnet_tpu_torch.graph import NetGraph
    from cxxnet_tpu_torch.models import kaiming
    from cxxnet_tpu_torch.nnet.net import FuncNet
    from cxxnet_tpu_torch.utils.config import parse_config
    g = NetGraph()
    g.configure(parse_config(kaiming(nclass=1000, batch_size=128,
                                     image_size=224, fused_pools=True))
                + [("dtype", "bfloat16"), ("pallas_pool", "1")])
    net = FuncNet(g, 128)
    shapes = set()
    for li, layer in enumerate(net.layer_objs):
        if g.effective_type(li) in ("conv", "fullc") \
                and layer.param.no_bias == 0:
            s = layer.out_shapes[0]
            shapes.add((128, s.x) if s.is_mat else (128, s.y, s.x, s.ch))
    return sorted(shapes)


def test_xla_bias_sum_plan_reads_the_hlo_rule():
    """The plan's windows and pads are those of the reduce-windows in
    the reference's optimized HLO, at every bias shape of kaiming-224's
    bf16 step (batch 128) and of the bit tests above (a dim of 32 or
    less is one whole window; the low side takes floor(pad / 2)). The
    last pass, a plain reduce of what the windows leave, is pinned by
    the bit tests."""
    kshapes = _kaiming224_bias_shapes()
    assert len(kshapes) == 9 and (128, 109, 109, 64) in kshapes
    for shape in kshapes + SHAPES:
        lead = (1, 1)[:4 - len(shape)]
        plan = kernels.xla_bias_sum_plan(lead + tuple(shape[:-1]))
        got = [step[len(lead):] for step in plan[:-1]]
        assert got == _hlo_reduce_windows(shape), shape


def test_bias_add_keeps_float32_outputs_plain():
    """A float32 output (fullc, or pallas_fullc's f32 product under
    dtype = bfloat16) adds its bias as before: PyTorch's own sum."""
    y = torch.randn(4, 6, requires_grad=True)
    b = torch.randn(6, requires_grad=True)
    (gb,) = torch.autograd.grad(kernels.bias_add(y, b).sum(), [b])
    np.testing.assert_array_equal(gb.numpy(), np.full(6, 4.0, np.float32))
