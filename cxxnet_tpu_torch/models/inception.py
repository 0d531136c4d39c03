"""Inception-v1 with batch norm ("Inception-BN") in the netconfig DSL.

A copy of ``cxxnet_tpu/models/inception.py``: GoogLeNet-style stem + 9
inception modules with ch_concat branches, every conv followed by
batch_norm + relu. The builders return config text, so both packages
parse the same net from the same string.
"""

from typing import List, Tuple


def _conv_bn_relu(lines: List[str], src: str, dst: str, name: str,
                  nch: int, k: int, stride: int = 1, pad: int = 0):
    lines.append("layer[%s->%s_c] = conv:%s_conv" % (src, dst, name))
    lines.append("  nchannel = %d" % nch)
    lines.append("  kernel_size = %d" % k)
    if stride != 1:
        lines.append("  stride = %d" % stride)
    if pad:
        lines.append("  pad = %d" % pad)
    lines.append("  no_bias = 1")
    lines.append("layer[%s_c->%s_b] = batch_norm:%s_bn" % (dst, dst, name))
    lines.append("layer[%s_b->%s] = relu" % (dst, dst))


def _inception(lines: List[str], src: str, name: str,
               n1: int, n3r: int, n3: int, nd3r: int, nd3: int,
               pool: str, np_: int, stride: int = 1):
    """One BN-inception module: 1x1 / 3x3 / double-3x3 / pool branches."""
    branches = []
    if n1 > 0:
        _conv_bn_relu(lines, src, "%s_b1" % name, "%s_1x1" % name, n1, 1)
        branches.append("%s_b1" % name)
    _conv_bn_relu(lines, src, "%s_b2r" % name, "%s_3x3r" % name, n3r, 1)
    _conv_bn_relu(lines, "%s_b2r" % name, "%s_b2" % name,
                  "%s_3x3" % name, n3, 3, stride, 1)
    branches.append("%s_b2" % name)
    _conv_bn_relu(lines, src, "%s_b3r" % name, "%s_d3r" % name, nd3r, 1)
    _conv_bn_relu(lines, "%s_b3r" % name, "%s_b3a" % name,
                  "%s_d3a" % name, nd3, 3, 1, 1)
    _conv_bn_relu(lines, "%s_b3a" % name, "%s_b3" % name,
                  "%s_d3b" % name, nd3, 3, stride, 1)
    branches.append("%s_b3" % name)
    if stride == 1:
        lines.append("layer[%s->%s_p] = %s_pooling" % (src, name, pool))
        lines.append("  kernel_size = 3")
        lines.append("  stride = 1")
        lines.append("  pad = 1")
        if np_ > 0:
            _conv_bn_relu(lines, "%s_p" % name, "%s_b4" % name,
                          "%s_proj" % name, np_, 1)
            branches.append("%s_b4" % name)
        else:
            branches.append("%s_p" % name)
    else:
        lines.append("layer[%s->%s_p] = max_pooling" % (src, name))
        lines.append("  kernel_size = 3")
        lines.append("  stride = 2")
        branches.append("%s_p" % name)
    lines.append("layer[%s->%s] = ch_concat" % (",".join(branches), name))
    return name


def inception_bn_tiny(nclass: int = 8, batch_size: int = 32,
                      image_size: int = 64, lr: float = 0.05) -> str:
    """Scaled-stem BN/concat net of the same topology class as
    Inception-BN (conv+batch_norm+relu stem, multi-branch modules with
    ch_concat incl. the avg-pool projection branch and a stride-2
    reduction module, global-avg-pool head) at small widths."""
    L: List[str] = ["netconfig=start"]
    _conv_bn_relu(L, "0", "c1", "conv1", 16, 3, 1, 1)
    L += ["layer[c1->p1] = max_pooling", "  kernel_size = 2",
          "  stride = 2"]
    top = "p1"
    modules: List[Tuple] = [
        ("t3a", 16, 8, 16, 8, 16, "avg", 16, 1),
        ("t3b", 0, 16, 24, 8, 16, "max", 0, 2),
        ("t4a", 24, 8, 16, 8, 16, "avg", 16, 1),
    ]
    for (nm, n1, n3r, n3, nd3r, nd3, pool, np_, st) in modules:
        top = _inception(L, top, nm, n1, n3r, n3, nd3r, nd3, pool, np_, st)
    gap = image_size // 4
    L += ["layer[%s->gap] = avg_pooling" % top,
          "  kernel_size = %d" % gap, "  stride = 1",
          "layer[gap->flat] = flatten",
          "layer[flat->fc] = fullc:fc1",
          "  nhidden = %d" % nclass,
          "  init_sigma = 0.01",
          "layer[fc->fc] = softmax",
          "netconfig=end",
          "input_shape = 3,%d,%d" % (image_size, image_size),
          "batch_size = %d" % batch_size,
          "momentum = 0.9",
          "eta = %g" % lr,
          "random_type = xavier",
          "metric = error"]
    return "\n".join(L) + "\n"


def inception_bn(nclass: int = 1000, batch_size: int = 128,
                 image_size: int = 224, lr: float = 0.01) -> str:
    L: List[str] = ["netconfig=start"]
    _conv_bn_relu(L, "0", "c1", "conv1", 64, 7, 2, 3)
    L += ["layer[c1->p1] = max_pooling", "  kernel_size = 3",
          "  stride = 2"]
    _conv_bn_relu(L, "p1", "c2r", "conv2red", 64, 1)
    _conv_bn_relu(L, "c2r", "c2", "conv2", 192, 3, 1, 1)
    L += ["layer[c2->p2] = max_pooling", "  kernel_size = 3",
          "  stride = 2"]
    top = "p2"
    # (name, 1x1, 3x3r, 3x3, d3r, d3, pool, proj, stride)
    modules: List[Tuple] = [
        ("i3a", 64, 64, 64, 64, 96, "avg", 32, 1),
        ("i3b", 64, 64, 96, 64, 96, "avg", 64, 1),
        ("i3c", 0, 128, 160, 64, 96, "max", 0, 2),
        ("i4a", 224, 64, 96, 96, 128, "avg", 128, 1),
        ("i4b", 192, 96, 128, 96, 128, "avg", 128, 1),
        ("i4c", 160, 128, 160, 128, 160, "avg", 128, 1),
        ("i4d", 96, 128, 192, 160, 192, "avg", 128, 1),
        ("i4e", 0, 128, 192, 192, 256, "max", 0, 2),
        ("i5a", 352, 192, 320, 160, 224, "avg", 128, 1),
        ("i5b", 352, 192, 320, 192, 224, "max", 128, 1),
    ]
    for (nm, n1, n3r, n3, nd3r, nd3, pool, np_, st) in modules:
        top = _inception(L, top, nm, n1, n3r, n3, nd3r, nd3, pool, np_, st)
    L += ["layer[%s->gap] = avg_pooling" % top,
          "  kernel_size = 7", "  stride = 1",
          "layer[gap->flat] = flatten",
          "layer[flat->fc] = fullc:fc1",
          "  nhidden = %d" % nclass,
          "  init_sigma = 0.01",
          "layer[fc->fc] = softmax",
          "netconfig=end",
          "input_shape = 3,%d,%d" % (image_size, image_size),
          "batch_size = %d" % batch_size,
          "momentum = 0.9",
          "wmat:lr = %g" % lr,
          "wmat:wd = 0.0001",
          "bias:lr = %g" % (lr * 2),
          "bias:wd = 0.000",
          "random_type = xavier",
          "metric = error",
          "metric = rec@1",
          "metric = rec@5"]
    return "\n".join(L) + "\n"
