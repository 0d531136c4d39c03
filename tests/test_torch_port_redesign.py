"""The host-side halves of two Hopper kernels of the port, on the CPU.

- ``bias_grad_bf16`` sums its chains with one ``add.rn.bf16x2`` per
  step where the reference adds in f32 and rounds to bf16. That is the
  same bits because rounding the exact sum of two bf16 values to f32
  and then to bf16 equals rounding it once: checked here exactly (the
  sum as a ``fractions.Fraction``, rounded once to bf16 to nearest even)
  on every class of ``chip_smoke.bf16_edge_classes``, the pairs the
  card's probe holds the instruction to.
- ``kernels.bias_grad_plan``: the chain floor against a direct count of
  the plain version's windows at AlexNet.conf's 8 and kaiming bf16's 14
  bias shapes, and the route and channel-group choice.
- ``kernels.pool_concat_plan``: the tower's fused concats take the
  16-byte vector route, the ragged case, an unaligned view, a
  channels-last view and a branch of the other dtype the scalar one;
  the tile fits its shared memory.
- The measurement wrappers raise on CPU tensors (no kernel there).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from cxxnet_tpu_torch.layers import kernels
from cxxnet_tpu_torch.nnet.net import FuncNet

BF16 = torch.bfloat16
GRID = 133          # every finite bf16 value is an integer times 2^-133
MAX_UNITS = 1 << (128 + GRID)   # 2^128: the first value past bf16's range


def _exact(bits: int):
    """A bf16 bit pattern's value as a Fraction, or None for inf and
    NaN."""
    if (bits >> 7) & 0xff == 0xff:
        return None
    f32 = np.array([bits << 16], dtype=np.uint32).view(np.float32)[0]
    return Fraction(float(f32))


def _round_once(q: Fraction, neg_zero: bool) -> int:
    """The bf16 bits of q rounded once, to nearest even."""
    if q == 0:
        return 0x8000 if neg_zero else 0
    units = q * (1 << GRID)
    assert units.denominator == 1
    units = int(units)
    sign, mag = (0x8000 if units < 0 else 0), abs(units)
    # below 2^-126 (2^7 units) the grid is one unit; above, 8 bits
    shift = max(0, mag.bit_length() - 8)
    q, r = divmod(mag, 1 << shift)
    half = 1 << shift >> 1
    if shift and (r > half or (r == half and q & 1)):
        q += 1
    mag = q << shift
    if mag >= MAX_UNITS:
        return sign | 0x7f80
    exp = max(0, mag.bit_length() - 8)
    man = mag >> exp
    if man >= 0x80:              # normal: hidden bit, biased exponent
        return sign | ((exp + 1) << 7) | (man & 0x7f)
    return sign | man            # subnormal


def _via_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PyTorch's bf16 add: the f32 sum of the two, rounded to bf16."""
    fa = torch.from_numpy(a.astype(np.int16)).view(BF16).float()
    fb = torch.from_numpy(b.astype(np.int16)).view(BF16).float()
    return (fa + fb).to(BF16).view(torch.int16).numpy().astype(np.uint16)


@pytest.mark.parametrize("cls", ["random", "subnormal", "signed_zero", "gap",
                                 "inf", "largest"])
def test_bf16_add_rounds_once(cls):
    a, b = chip_smoke.bf16_edge_classes()[cls]
    got = _via_f32(a, b)
    checked = 0
    for x, y, g in zip(a.tolist(), b.tolist(), got.tolist()):
        ux, uy = _exact(x), _exact(y)
        if ux is None or uy is None:
            # inf or NaN in: inf + -inf and NaN give NaN, else the inf
            nan_in = any((v >> 7) & 0xff == 0xff and v & 0x7f
                         for v in (x, y))
            infs = {v for v in (x, y) if (v & 0x7fff) == 0x7f80}
            if nan_in or len(infs) == 2:
                assert (g >> 7) & 0xff == 0xff and g & 0x7f, (x, y, g)
            else:
                assert g == infs.pop(), (x, y, g)
            checked += 1
            continue
        # -0 + -0 is -0; x + -x and +0 + -0 are +0 (round to nearest)
        want = _round_once(ux + uy, x == 0x8000 and y == 0x8000)
        assert g == want, (hex(x), hex(y), hex(g), hex(want))
        checked += 1
    assert checked == len(a)


def _direct_chain(dims) -> int:
    """The plain version's passes run on an indicator of real elements:
    the longest window's real elements per pass, summed."""
    t = torch.ones(tuple(dims) + (1,), dtype=torch.float64)
    total = 0
    for step in kernels.xla_bias_sum_plan(dims):
        pads = []
        for (n, w, lo), d in zip(reversed(step), reversed(t.shape[:3])):
            pads += [lo, n * w - d - lo]
        t = F.pad(t, [0, 0] + pads)
        (n0, w0, _), (n1, w1, _), (n2, w2, _) = step
        counts = t.reshape(n0, w0, n1, w1, n2, w2, 1).sum((1, 3, 5))
        total += int(counts.max())
        t = torch.ones((n0, n1, n2, 1), dtype=torch.float64)
    return total


def _bias_shapes(cfg, batch):
    return chip_smoke.path_bias_shapes(
        FuncNet(chip_smoke._configured(cfg), batch), batch)


def _nbdc(shape):
    return shape if len(shape) == 4 else (1, 1) + tuple(shape)


def _dense(shape):
    a, b, d, c = shape
    return (b * d * c, d * c, c, 1)


@pytest.mark.parametrize("net", ["alexnet", "kaiming_bf16"])
def test_bias_chain_floor_counts_the_plain_windows(net):
    shapes = _bias_shapes(chip_smoke.alexnet_cfg(256), 256) \
        if net == "alexnet" else \
        _bias_shapes(chip_smoke.kaiming_cfg_bf16(128), 128)
    assert len(shapes) == (8 if net == "alexnet" else 14)
    for shape in shapes:
        sh = _nbdc(shape)
        plan = kernels.bias_grad_plan(sh, _dense(sh))
        assert plan["chain"] == _direct_chain(sh[:3]), shape
        assert plan["routes"][0] == "ring", shape
    if net == "alexnet":
        # conv1 25,120, conv2 23,336, conv3-5 5,416, three fullc 40
        assert sum(kernels.bias_grad_plan(_nbdc(s), _dense(_nbdc(s)))
                   ["chain"] for s in shapes) == 64824


@pytest.mark.parametrize("shape,strides,align,want", [
    # conv1: 32 windows; 16 channels a block fill 132 SMs (192 blocks);
    # its 8 x 2 x 2 partials: one window of 2-row lines
    ((256, 55, 55, 96), None, 16, (["ring", "ring"], [16, 64])),
    # the 13 x 13 maps: 16 channels a block (a cursor step of 16 rows
    # needs D >= 8)
    ((256, 13, 13, 384), None, 16, (["ring", "direct"], [16, 0])),
    # a 5 x 5 map: 64 channels a block (D >= 2), 4 x 36 blocks
    ((128, 5, 5, 2304), None, 16, (["ring", "direct"], [64, 0])),
    # fullc: 8 windows x 64 groups already fill the card
    ((1, 1, 256, 4096), None, 16, (["ring", "ring"], [64, 16])),
    # an odd C, a C not a multiple of 8, a misaligned base, a channel
    # stride: the direct route
    ((64, 14, 14, 77), None, 16, (["direct", "direct"], [0, 0])),
    ((128, 7, 7, 100), None, 16, (["direct", "direct"], [0, 0])),
    ((64, 14, 14, 64), (14 * 14 * 66, 14 * 66, 66, 1), 2,
     (["direct", "direct"], [0, 0])),
    ((64, 14, 14, 64), (14 * 14 * 64, 14, 1, 196),
     16, (["direct", "direct"], [0, 0])),
    # a last reduced dim shorter than half the widest group's step
    ((1, 1, 1, 64), None, 16, (["direct"], [0])),
])
def test_bias_grad_plan_routes_and_groups(shape, strides, align, want):
    plan = kernels.bias_grad_plan(shape, strides or _dense(shape), align)
    assert (plan["routes"], plan["groups"]) == want
    assert len(plan["passes"]) == len(want[0])


def test_bias_grad_plan_narrows_groups_only_to_fill_the_card():
    sh = (256, 55, 55, 96)
    assert kernels.bias_grad_plan(sh, _dense(sh), sms=32)["groups"][0] == 64
    assert kernels.bias_grad_plan(sh, _dense(sh), sms=96)["groups"][0] == 32
    assert kernels.bias_grad_plan(sh, _dense(sh), sms=1000)["groups"][0] == 16


def _concat_shapes(dtype):
    cfg = chip_smoke.tower_train_cfg_bf16 if dtype == "bfloat16" \
        else chip_smoke.tower_train_cfg
    return chip_smoke.path_concat_shapes(
        FuncNet(chip_smoke._configured(cfg(128)), 128), 128)


def _plan(widths, dtypes, strides, aligns, out, pos, k, b, h, w):
    return kernels.pool_concat_plan(widths, dtypes, strides, aligns, out,
                                    pos, k, b, h, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_concat_plan_vectors_every_tower_concat(dtype):
    shapes = _concat_shapes(dtype)
    assert len(shapes) == len(chip_smoke.TOWER_FUSED[dtype])
    v = 4 if dtype == "float32" else 8
    esz = 16 // v
    for widths, pos, k, mode, h, w, b in shapes:
        strides = [(h * w * c, w * c, c, 1) for c in widths]
        plan = _plan(widths, [dtype] * len(widths), strides,
                     [256] * len(widths), dtype, pos, k, b, h, w)
        assert plan["routes"] == ["vec"] * len(widths)
        assert plan["v"] == v and plan["cc"] * esz == kernels.PC_JOB_BYTES
        assert plan["smem"] == (plan["tr"] + k - 1) * (plan["tw"] + k - 1) \
            * plan["cc"] * esz <= kernels.PC_MAX_SMEM
        assert plan["blocks"] == b * plan["rtiles"] * plan["ctiles"] \
            * sum(plan["jobs"])
        assert plan["rtiles"] * plan["tr"] >= h > (plan["rtiles"] - 1) \
            * plan["tr"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_concat_plan_takes_the_scalar_route(dtype):
    other = "bfloat16" if dtype == "float32" else "float32"
    esz = 4 if dtype == "float32" else 2
    widths = (64, 64, 96, 192)
    dense = [(28 * 28 * c, 28 * c, c, 1) for c in widths]
    # the ragged widths of chip_smoke's extra case: no branch's offset or
    # width is a whole vector
    rag = (13, 7, 5, 19)
    plan = _plan(rag, [dtype] * 4, [(28 * 28 * c, 28 * c, c, 1)
                                    for c in rag], [256] * 4, dtype, 2, 5,
                 16, 28, 28)
    assert plan["routes"] == ["scalar"] * 4
    # a channel slice two elements in: its base is off 16 bytes
    sliced = [(28 * 28 * (c + 4), 28 * (c + 4), c + 4, 1) for c in widths]
    plan = _plan(widths, [dtype] * 4, sliced, [2 * esz] * 4, dtype, 3, 3,
                 16, 28, 28)
    assert plan["routes"] == ["scalar"] * 4
    # a channels-last view of an NCHW tensor: channel stride H*W
    nchw = [(c * 784, 28, 1, 784) for c in widths]
    plan = _plan(widths, [dtype] * 4, nchw, [256] * 4, dtype, 3, 3, 16, 28,
                 28)
    assert plan["routes"] == ["scalar"] * 4
    # branches of the other dtype are cast element by element
    plan = _plan(widths, [dtype, other, dtype, other], dense, [256] * 4,
                 dtype, 2, 3, 16, 28, 28)
    assert plan["routes"] == ["vec", "scalar", "vec", "scalar"]
    # one misaligned output offset sends its branch to the scalar route
    # output offsets 0, 62, 64, 160: the first two branches' widths and
    # the second's offset are not whole vectors
    plan = _plan((62, 2, 96, 192), [dtype] * 4,
                 [(28 * 28 * c, 28 * c, c, 1) for c in (62, 2, 96, 192)],
                 [256] * 4, dtype, 3, 3, 16, 28, 28)
    assert plan["routes"] == ["scalar", "scalar", "vec", "vec"]


def test_pool_concat_plan_shrinks_the_tile_for_wide_windows():
    plan = _plan((64, 64), ["float32"] * 2, [(64 * 64 * 64, 64 * 64, 64, 1)]
                 * 2, [256] * 2, "float32", 1, 51, 2, 64, 64)
    assert plan["smem"] <= kernels.PC_MAX_SMEM
    assert plan["tw"] < kernels.PC_TILE_COLS
    with pytest.raises(ValueError, match="shared memory"):
        _plan((64, 64), ["float32"] * 2, [(1, 1, 1, 1)] * 2, [256] * 2,
              "float32", 1, 161, 2, 8, 8)


@pytest.mark.parametrize("fn", ["pairs", "chain"])
def test_measurement_wrappers_raise_on_the_cpu(fn):
    x = torch.zeros(128, dtype=BF16)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        if fn == "pairs":
            kernels.bf16_add_pairs(x, x)
        else:
            kernels.bf16_add_chain(x, 4)


def test_bias_grad_plan_chain_is_the_floor_of_each_pass():
    # AlexNet's conv1: 32 x 28 x 28 real elements in its longest window,
    # then the 32 partials
    plan = kernels.bias_grad_plan((256, 55, 55, 96), _dense((256, 55, 55, 96)))
    assert plan["chain"] == 32 * 28 * 28 + 8 * 2 * 2
    assert math.prod(s[1] for s in plan["passes"][0]) == 32 ** 3


def _line_lengths(step, dims):
    """The real rows of every window's last-dim line in one pass."""
    n, w, lo = step[2]
    return [min(dims[2], (i + 1) * w - lo) - max(0, i * w - lo)
            for i in range(n)]


@pytest.mark.parametrize("shape,strides,short", [
    # windows of 25 x 4 rows at 32 channels a block (a cursor step of 8)
    ((8, 50, 4, 64), None, True),
    # lines of 8 rows at 16 channels a block (a step of 16)
    ((128, 45, 8, 64), None, True),
    # planes of 4 rows under a step of 8, every other item of a batch
    ((64, 1, 4, 64), (512, 0, 64, 1), True),
    ((64, 27, 27, 64), (2 * 27 * 27 * 64, 27 * 64, 64, 1), False),
    # AlexNet's conv1 (its dense partials: lines of 2 under a step of 4),
    # conv3 (lines of 13 under 16, whole planes: no carry moves an
    # offset) and a 5 x 5 map
    ((256, 55, 55, 96), None, False),
    ((256, 13, 13, 384), None, True),
    ((128, 5, 5, 2304), None, False),
])
def test_bias_ring_lines_hold_half_the_cursor_step(shape, strides, short):
    # the ring copier steps its row cursor 256 / G rows with at most two
    # line carries, which needs every window line of a ring pass at
    # least half a step long; a first pass with lines shorter than a
    # whole step is the case where a lane's first row lies past its
    # window's first line (chip_smoke.bias_grad_extra's ring cases)
    plan = kernels.bias_grad_plan(shape, strides or _dense(shape))
    dims, shorts = shape[:3], []
    for step, route, g in zip(plan["passes"], plan["routes"],
                              plan["groups"]):
        if route == "ring":
            lines = _line_lengths(step, dims)
            assert 2 * min(lines) >= 256 // g, (step, g)
            shorts.append(min(lines) < 256 // g)
        dims = tuple(s[0] for s in step)
    assert plan["routes"][0] == "ring"
    assert shorts[0] == short


@pytest.mark.parametrize("dtype,itemsize", [("float32", 4),
                                            ("bfloat16", 2)])
def test_pool_concat_plan_fits_every_window_the_gate_admits(dtype, itemsize):
    # the reference's 6 MiB gate admits the widest windows on the
    # smallest maps; the plan must tile each of them
    for hw, ctot in [(1, 16), (2, 16), (2, 128), (7, 256)]:
        k = max(k for k in range(3, 301, 2)
                if kernels.pool_concat_applicable(hw, hw, ctot, k, itemsize))
        widths = (ctot // 2, ctot // 2)
        plan = _plan(widths, [dtype] * 2,
                     [(hw * hw * c, hw * c, c, 1) for c in widths], [256] * 2,
                     dtype, 1, k, 2, hw, hw)
        assert plan["smem"] <= kernels.PC_SMEM_LIMIT, (hw, ctot, k)
        if plan["smem"] > kernels.PC_MAX_SMEM:
            assert (plan["tr"], plan["tw"], plan["cc"]) == (1, 1, plan["v"])
