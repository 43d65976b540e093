"""Operations a batch needs, by precision class, from the configuration's
shapes and the benchmark's own rule counts.

Counted: the sparse convs (2 Cin Cout per found pair, `roofline.
sparse_launches`), the PFN's linear layer (2 x 10 x C over every point
slot of the live pillars), the RPN's 3x3 convs and transposed convs
(2 Cin Cout k^2 per output position) and the 1x1 heads.  In training the
backward adds, for each dense layer, its data and weight gradients (2x
the forward).  BatchNorm, activations, the loss and NMS are not counted.
The `precision` section of the configuration file names each class's
precision (`bfloat16`, `tf32`, `float32`).
"""
from . import roofline


def rpn_ops(cfg, c_in, bev_hw, batch):
    """(block convs and deconvs ops, heads ops) of RPNV2 for `batch` BEVs
    of (H, W) and `c_in` channels with the configuration's widths."""
    a = cfg['MODEL']['RPN']['RPN_HEAD']['ARGS']
    h, w = bev_hw
    conv = 0
    for i, n in enumerate(a['layer_nums']):
        s = a['layer_strides'][i]
        nf = a['num_filters'][i]
        h, w = h // s, w // s
        for j in range(n + 1):
            cin = c_in if j == 0 else nf
            conv += 2 * cin * nf * 9 * h * w
        u, up = a['upsample_strides'][i], a['num_upsample_filters'][i]
        conv += 2 * nf * up * u * u * h * w
        c_in = nf
        out_hw = (h * u, w * u)
    c_head = sum(a['num_upsample_filters'])
    na = 2 * len(cfg['CLASS_NAMES'])
    width = na * (7 + len(cfg['CLASS_NAMES']) + 2)
    heads = 2 * c_head * width * out_hw[0] * out_hw[1]
    return conv * batch, heads * batch


def batch_ops(ref, precision, work, pillars, batch, train):
    """({precision: operations}, least sparse seconds) of one batch.

    :param ref: the reference model (`reference.net.RefModel`)
    :param precision: the configuration's precision section for this mode
    :param work: per-conv counts of the batch's sparse convs (SECOND)
    :param pillars: live pillars of the batch (PointPillar)
    """
    cfg = ref.cfg
    ops = {}

    def add(p, o):
        ops[p] = ops.get(p, 0) + o

    grad = 3 if train else 1
    least = 0.0
    if ref.kind == 'second':
        least, sp = roofline.sparse_launches(work, train,
                                             precision['sparse_conv'])
        for p, o in sp.items():
            add(p, o)
        bev_hw = ref.sparse_shape[1] // 8, ref.sparse_shape[2] // 8
    else:
        add(precision['pfn'], 2 * 10 * ref.pfn_filters * ref.max_points
            * pillars * grad)
        bev_hw = ref.grid[1], ref.grid[0]
    conv, heads = rpn_ops(cfg, ref.bev_channels, bev_hw, batch)
    add(precision['rpn_conv'], conv * grad)
    add(precision['heads'], heads * grad)
    return ops, least


def least_seconds(ops):
    """Seconds the ops need at their classes' peaks."""
    return sum(o / roofline.PEAK_OPS_PER_S[p] for p, o in ops.items())
