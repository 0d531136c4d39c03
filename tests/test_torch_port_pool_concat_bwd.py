"""The pool_concat backward's tiled gather (``csrc/pool_concat.cu``
``cxn_pool_concat_bwd_tile``) on the CPU, where no kernel runs.

- ``kernels.pool_concat_bwd_plan``: the vector route at every backward
  launch of the Inception tower (f32 t3a / t4a, bf16 t3a / t3b / t4a)
  for NHWC-dense tensors; the scalar route for a permuted cotangent, a
  base 4 bytes off and an x of the other dtype; both staged tensors
  within the shared memory a block has for every window the
  reference's gate admits.
- A torch emulation of the kernel's tiles: the halo clipped to the map,
  the taps walked in (di, dj) row-major order from it, an f32
  accumulator a channel from +0 (in bf16 under max the cotangent masked
  to +0 rather than skipped), one rounding to x's dtype. It gives the
  bits (exact: no tolerance) of the reference's VJP
  (``pallas_kernels._pool_concat_vjp_bwd`` through ``jax.vjp`` of the
  Pallas forward in interpret mode, compiled with excess precision off
  as the other pool_concat tests run it) and of
  ``kernels.pool_concat_bwd_plain``, on inputs in steps of 0.5 (ties,
  exact zeros on the borders), NaN, N(0, 9) cotangents, k = 3 and 5,
  f32 and bf16, and maps smaller than a tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cxxnet_tpu.layers import pallas_kernels as jax_pk
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.nnet.net import FuncNet

NO_EXCESS = {"xla_allow_excess_precision": False}


def _dense(b, h, w, c):
    return tuple(0 if n == 1 else s for n, s in
                 zip((b, h, w, c), (h * w * c, w * c, c, 1)))


def _tower_backwards(dtype):
    cfg = chip_smoke.tower_train_cfg_bf16 if dtype == "bfloat16" \
        else chip_smoke.tower_train_cfg
    return chip_smoke.path_concat_shapes(
        FuncNet(chip_smoke._configured(cfg(128)), 128), 128)


def _plan(b, h, w, widths, pos, k, mode, dtype, xdtype=None, dy=None,
          aligns=(256, 256, 256)):
    c, ctot = widths[pos], sum(widths)
    return kernels.pool_concat_bwd_plan(
        b, h, w, c, sum(widths[:pos]), k, mode, (xdtype or dtype, dtype),
        (_dense(b, h, w, c), dy or _dense(b, h, w, ctot),
         _dense(b, h, w, ctot)), aligns)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plan_vectors_every_tower_backward(dtype):
    shapes = _tower_backwards(dtype)
    assert len(shapes) == len(chip_smoke.TOWER_FUSED[dtype])
    v, esz = (4, 4) if dtype == "float32" else (8, 2)
    for widths, pos, k, mode, h, w, b in shapes:
        plan = _plan(b, h, w, widths, pos, k, mode, dtype)
        assert plan["route"] == "vec", (widths, pos, mode)
        # jobs of 128 bytes, or of 64 where a stage would pass its cap
        assert plan["v"] == v \
            and plan["cc"] * esz in (kernels.PC_JOB_BYTES, 64)
        hr, hc = plan["halo"]
        assert (hr, hc) == (min(plan["tr"] + k - 1, h),
                            min(plan["tw"] + k - 1, w))
        per = 1 if mode == "avg" else 2
        assert plan["staged"] == (["dy"] if mode == "avg"
                                  else ["dy", "out", "x"])
        stage = (per * hr * hc + (per - 1) * plan["tr"] * plan["tw"]) \
            * plan["cc"] * esz
        assert plan["smem"] == stage <= kernels.PC_BWD_STAGE
        assert plan["blocks"] == b * plan["rtiles"] * plan["ctiles"] \
            * plan["jobs"]
        assert plan["jobs"] * plan["cc"] >= widths[pos]
        assert plan["threads"] % 32 == 0 \
            and plan["threads"] <= kernels.PC_BWD_THREADS
        # one pass of the block's threads covers a tile's work evenly
        items = plan["tr"] * plan["tw"] * plan["cc"] // v
        rounds = -(-items // plan["threads"])
        assert rounds == -(-items // kernels.PC_BWD_THREADS)


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plan_takes_the_scalar_route(dtype, mode):
    other = "bfloat16" if dtype == "float32" else "float32"
    widths, pos = (64, 64, 96, 192), 3
    b, h, w, ctot = 16, 28, 28, 416
    assert _plan(b, h, w, widths, pos, 3, mode, dtype)["route"] == "vec"
    # a permuted cotangent: channel stride H*W
    nchw = (ctot * h * w, w, 1, h * w)
    assert _plan(b, h, w, widths, pos, 3, mode, dtype,
                 dy=nchw)["route"] == "scalar"
    # every base 4 bytes off a vector (a channel slice two bf16 in)
    assert _plan(b, h, w, widths, pos, 3, mode, dtype,
                 aligns=(4, 4, 4))["route"] == "scalar"
    # x of the other dtype (read through it, dx of it)
    assert _plan(b, h, w, widths, pos, 3, mode, dtype,
                 xdtype=other)["route"] == "scalar"
    # a segment offset off the vector
    assert _plan(b, h, w, (2, 64), 1, 3, mode, dtype)["route"] == "scalar"
    # avg reads neither x nor the output: their layout does not count
    plan = kernels.pool_concat_bwd_plan(
        b, h, w, 192, 224, 3, mode, (dtype, dtype),
        ((1, 1, 1, 3), _dense(b, h, w, ctot), (1, 1, 1, 3)), (2, 256, 2))
    assert plan["route"] == ("vec" if mode == "avg" else "scalar")


@pytest.mark.parametrize("hw", [2, 28])
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("dtype,itemsize", [("float32", 4),
                                            ("bfloat16", 2)])
def test_bwd_plan_fits_every_window_the_gate_admits(dtype, itemsize, mode,
                                                    hw):
    for ctot in (16, 128, 640):
        ks = [k for k in range(3, 301, 2)
              if kernels.pool_concat_applicable(hw, hw, ctot, k, itemsize)]
        widths = (ctot // 2, ctot // 2)
        for k in ks:
            for aligns in ((256, 256, 256), (4, 4, 4)):
                plan = _plan(2, hw, hw, widths, 1, k, mode, dtype,
                             aligns=aligns)
                assert plan["smem"] <= kernels.PC_SMEM_LIMIT, (ctot, k)
                if plan["smem"] > kernels.PC_BWD_STAGE:
                    assert (plan["tr"], plan["tw"], plan["cc"]) \
                        == (1, 1, plan["v"])
    # unclipped, the widest bf16 max window on a 2 x 2 map would not fit
    if dtype == "bfloat16" and hw == 2:
        k = max(k for k in range(3, 301, 2)
                if kernels.pool_concat_applicable(2, 2, 16, k, 2))
        assert k == 89 and 2 * k * k * 16 > kernels.PC_SMEM_LIMIT


def _emulate(x, out, dy, off, k, mode, tr, tw):
    """The kernel's gather, tile by tile: the outputs covering a tile of
    tr x tw input pixels staged clipped to the map, each input's taps
    (di, dj) in row-major order read from there where they lie in the
    map, f32 accumulation from +0, one rounding to x's dtype; in bf16
    under max every such tap is added, its cotangent masked to +0 where
    x != out. Channels are independent, so a job's channel split changes
    no bit."""
    b, h, w, c = x.shape
    p = k // 2
    dyf = dy[..., off:off + c].float()
    outf = out[..., off:off + c].float() if mode == "max" else None
    xf = x.float()
    inv = torch.tensor(1.0 / (k * k), dtype=torch.float32)
    dx = torch.empty((b, h, w, c), dtype=torch.float32)
    for i0 in range(0, h, tr):
        for j0 in range(0, w, tw):
            rows, cols = min(tr, h - i0), min(tw, w - j0)
            oi0, oj0 = max(0, i0 - p), max(0, j0 - p)
            hr = min(h - 1, i0 + rows - 1 + p) - oi0 + 1
            hc = min(w - 1, j0 + cols - 1 + p) - oj0 + 1
            assert hr <= min(tr + k - 1, h) and hc <= min(tw + k - 1, w)
            sdy = dyf[:, oi0:oi0 + hr, oj0:oj0 + hc]
            sout = outf[:, oi0:oi0 + hr, oj0:oj0 + hc] \
                if outf is not None else None
            xt = xf[:, i0:i0 + rows, j0:j0 + cols]
            br, bc = i0 + p - oi0, j0 + p - oj0
            acc = torch.zeros((b, rows, cols, c), dtype=torch.float32)
            for di in range(k):
                rr = torch.arange(rows) + br - di
                for dj in range(k):
                    cc = torch.arange(cols) + bc - dj
                    inside = ((rr >= 0) & (rr < hr))[:, None] \
                        & ((cc >= 0) & (cc < hc))[None, :]
                    ri, ci = rr.clamp(0, hr - 1), cc.clamp(0, hc - 1)
                    g = sdy[:, ri][:, :, ci]
                    take = inside[None, :, :, None].expand_as(acc)
                    if mode == "avg":
                        add = g * inv
                    elif x.dtype == torch.bfloat16:
                        # every tap in the map added, dy masked to +0
                        # where x != out (two channels an instruction)
                        add = torch.where(xt == sout[:, ri][:, :, ci], g,
                                          torch.zeros_like(g))
                    else:
                        take = take & (xt == sout[:, ri][:, :, ci])
                        add = g
                    acc = torch.where(take, acc + add, acc)
            dx[:, i0:i0 + rows, j0:j0 + cols] = acc
    return dx.to(x.dtype)


def _bits(t):
    """float32 bit patterns, NaN (any payload) as one pattern."""
    a = np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t,
                   np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


CASES = [(mode, dt, k, hw) for mode in ("max", "avg")
         for dt in ("float32", "bfloat16") for k in (3, 5)
         for hw in ((9, 37), (3, 2))]


@pytest.mark.parametrize("mode,dtype,k,hw", CASES,
                         ids=["%s-%s-k%d-%dx%d" % (c[:3] + c[3])
                              for c in CASES])
def test_emulated_gather_gives_the_reference_vjp_bits(mode, dtype, k, hw):
    h, w = hw
    rng = np.random.RandomState(k + 10 * h + w)
    widths, pos = (8, 16, 8), 1
    off, c = sum(widths[:pos]), widths[pos]
    dt = getattr(torch, dtype)
    xs = []
    for i, ch in enumerate(widths):
        v = np.round(2 * rng.randn(2, h, w, ch)) / 2
        if i == pos:
            # zeros and negatives tie with the pad on the borders
            v = np.where(rng.rand(*v.shape) < 0.3, -np.abs(v), v)
            if mode == "max":
                v.reshape(-1)[::23] = np.nan
        xs.append(torch.from_numpy(v.astype(np.float32)).to(dt))
    scale = 1.0 if mode == "max" else 3.0
    dy = rng.randn(2, h, w, sum(widths)) * scale
    if mode == "max":
        dy = np.round(2 * dy) / 2
    dy = torch.from_numpy(dy.astype(np.float32)).to(dt)
    out = kernels.pool_concat_plain(xs, pos, k, mode)
    plain = kernels.pool_concat_bwd_plain(xs[pos], out, dy, off, k, mode)

    jx = [jnp.asarray(x.float().numpy()).astype(dtype) for x in xs]
    jdy = jnp.asarray(dy.float().numpy()).astype(dtype)

    def ref(*bs):
        o, vjp = jax.vjp(lambda *a: jax_pk.pool_concat(a, pos, k, mode), *bs)
        return o, vjp(jdy)[pos]
    jout, jdx = jax.jit(ref).lower(*jx).compile(
        compiler_options=NO_EXCESS)(*jx)
    # the forwards agree but for the sign of a zero maximum (jnp.maximum
    # and torch.maximum pick -0 and +0 apart), which no compare sees
    np.testing.assert_array_equal(np.isnan(jout), torch.isnan(out).numpy())
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(jout, np.float32)),
                                  np.nan_to_num(out.float().numpy()))

    plan = _plan(2, h, w, widths, pos, k, mode, dtype)
    assert plan["route"] == "vec"
    tiles = {(plan["tr"], plan["tw"]), (2, 3), (1, 1)}
    if max(hw) <= min(kernels.PC_TILE_ROWS, kernels.PC_TILE_COLS):
        # the whole map is one tile
        assert (plan["tr"], plan["tw"]) == hw
    for tr, tw in sorted(tiles):
        got = _emulate(xs[pos], out, dy, off, k, mode, tr, tw)
        assert got.dtype == dt
        np.testing.assert_array_equal(_bits(got), _bits(plain),
                                      err_msg="tile %dx%d" % (tr, tw))
        np.testing.assert_array_equal(_bits(got), _bits(jdx),
                                      err_msg="tile %dx%d" % (tr, tw))
    if mode == "max":
        assert torch.isnan(plain).any() or torch.isnan(out).any()
    assert not torch.equal(plain, torch.zeros_like(plain))
