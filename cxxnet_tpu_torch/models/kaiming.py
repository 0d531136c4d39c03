"""Kaiming He "constrained time cost" convnet (CVPR 2015, model J')
in the netconfig DSL.

A copy of ``cxxnet_tpu/models/kaiming.py``; its topology is the
reference cxxnet's ``example/ImageNet/kaiming.conf``: a 7x7/2 stem,
three stages of 2x2 convs (the paper's replacement for 3x3),
stride-3/stride-2 downsampling convs instead of pooled stride, 1-stride
3x3 max pools between stages, a 4-level spatial-pyramid pooling head
(split -> max pools k1/s1, k2/s2, k3/s3, k6/s6 -> flatten -> concat),
and a 4096-4096-nclass FC classifier with dropout. The builders return
config text, so both packages parse the same net from the same string.
"""


def _stage(lines, idx, node, convs, pool=None, fused_pools=False):
    """Append `convs` = [(nchannel, kernel, stride, pad), ...] then an
    optional (kernel, stride) max pool to `lines` in place; returns the
    advanced (idx, node) counters. fused_pools folds the last relu and
    a stride-1 pool into one relu_max_pooling layer (identical math;
    with ``pallas_pool = 1`` it runs the relu_max_pool kernel)."""
    n = len(convs)
    for ci, (nch, k, s, p) in enumerate(convs):
        lines.append("layer[%d->%d] = conv:conv%d" % (node, node + 1, idx))
        lines.append("  nchannel = %d" % nch)
        lines.append("  kernel_size = %d" % k)
        if s != 1:
            lines.append("  stride = %d" % s)
        if p != 0:
            lines.append("  pad = %d" % p)
        fuse_here = (fused_pools and ci == n - 1 and pool is not None
                     and pool[1] == 1)
        if not fuse_here:
            lines.append("layer[%d->%d] = relu:relu%d"
                         % (node + 1, node + 2, idx))
            node += 2
        else:
            node += 1
        idx += 1
    if pool is not None:
        k, s = pool
        typ = ("relu_max_pooling" if fused_pools and s == 1
               else "max_pooling")
        lines.append("layer[%d->%d] = %s:pool_s%d"
                     % (node, node + 1, typ, idx))
        lines.append("  kernel_size = %d" % k)
        if s != 1:
            lines.append("  stride = %d" % s)
        node += 1
    return idx, node


def kaiming(nclass: int = 1000, batch_size: int = 128,
            image_size: int = 224, lr: float = 0.01,
            fused_pools: bool = False) -> str:
    lines = ["netconfig=start"]
    # stage 1: stem
    lines += ["layer[0->1] = conv:conv1",
              "  kernel_size = 7", "  stride = 2", "  nchannel = 64"]
    if fused_pools:
        lines += ["layer[1->2] = relu_max_pooling:pool_stem",
                  "  kernel_size = 3"]
        idx, node = 2, 2
    else:
        lines += ["layer[1->2] = relu:relu1",
                  "layer[2->3] = max_pooling:pool_stem",
                  "  kernel_size = 3"]
        idx, node = 2, 3
    # stage 2: 128-ch 2x2 convs (first one downsamples with stride 3)
    idx, node = _stage(lines, idx, node,
                       [(128, 2, 3, 0), (128, 2, 1, 1),
                        (128, 2, 1, 0), (128, 2, 1, 1)], pool=(3, 1),
                       fused_pools=fused_pools)
    # stage 3: 256-ch 2x2 convs (first one downsamples with stride 2)
    idx, node = _stage(lines, idx, node,
                       [(256, 2, 2, 0), (256, 2, 1, 1),
                        (256, 2, 1, 0), (256, 2, 1, 1)], pool=(3, 1),
                       fused_pools=fused_pools)
    # stage 4: wide 2304-ch downsampling conv + 256-ch conv
    idx, node = _stage(lines, idx, node,
                       [(2304, 2, 3, 0), (256, 2, 1, 1)])
    # stage 5: 4-level spatial pyramid pooling head
    s = node
    lines.append("layer[%d->%d,%d,%d,%d] = split:split1"
                 % (s, s + 1, s + 2, s + 3, s + 4))
    flat = []
    for i, k in enumerate((1, 2, 3, 6)):
        lines.append("layer[%d->%d] = max_pooling:spp%d"
                     % (s + 1 + i, s + 5 + i, i + 1))
        lines.append("  kernel_size = %d" % k)
        if k != 1:
            lines.append("  stride = %d" % k)
        lines.append("layer[%d->%d] = flatten:flat%d"
                     % (s + 5 + i, s + 9 + i, i + 1))
        flat.append(s + 9 + i)
    node = s + 13
    lines.append("layer[%s->%d] = concat:concat1"
                 % (",".join(str(f) for f in flat), node))
    # stage 6: classifier
    for i, nh in enumerate((4096, 4096)):
        lines.append("layer[%d->%d] = fullc:fc%d" % (node, node + 1, i + 1))
        lines.append("  nhidden = %d" % nh)
        lines.append("layer[%d->%d] = relu:relu_fc%d"
                     % (node + 1, node + 2, i + 1))
        node += 2
        lines.append("layer[%d->%d] = dropout:drop%d" % (node, node, i + 1))
        lines.append("  threshold = 0.5")
    lines.append("layer[%d->%d] = fullc:fc3" % (node, node + 1))
    lines.append("  nhidden = %d" % nclass)
    node += 1
    lines.append("layer[%d->%d] = softmax:softmax1" % (node, node))
    lines.append("netconfig=end")
    lines.append("""
metric = rec@1
metric = rec@5
input_shape = 3,%d,%d
batch_size = %d
momentum = 0.9
wmat:lr = %g
wmat:wd = 0.0005
bias:wd = 0.000
bias:lr = %g
lr:schedule = factor
lr:gamma = 0.1
lr:step = 300000
random_type = xavier
""" % (image_size, image_size, batch_size, lr, lr * 2))
    return "\n".join(lines)
