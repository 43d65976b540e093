"""Plain anchor-head loss and the adam_onecycle update.

Loss (PCDet's AnchorHead): sigmoid focal loss (gamma 2, alpha 0.25) over
positives and negatives, smooth-L1 (sigma 3) of the residual codes of the
positives with the heading as sin(a - b), softmax direction loss over two
bins of the positives; each weighted by 1 / (the scan's positives, at
least 1), summed, divided by the batch and scaled by the config's loss
weights.  Update: the gradients clipped to a global norm of
GRAD_NORM_CLIP, Adam with the OneCycle momentum as beta1 (beta2 0.99, eps
1e-8 outside the root, bias correction with the current beta1), then the
decoupled weight decay, at the OneCycle learning rate.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F


def _limit_period(val, offset, period):
    return val - torch.floor(val / period + offset) * period


def anchor_loss(out, anchors, labels, reg_targets, cfg):
    """:param out: the reference's head outputs; :param anchors: (A, 7)
    tensor; :param labels: (B, A) int64; :param reg_targets: (B, A, 7)
    :return: total loss (scalar) and its parts"""
    lw = cfg['MODEL']['LOSSES']['LOSS_WEIGHTS']
    args = cfg['MODEL']['RPN']['RPN_HEAD']['ARGS']
    cls, box, dirp = out['cls'], out['box'], out['dir']
    b, c = cls.shape[0], cls.shape[2]
    pos = (labels > 0).to(cls.dtype)
    neg = (labels == 0).to(cls.dtype)
    norm = torch.clamp(pos.sum(1, keepdim=True), min=1.0)
    cls_w = (pos + neg) / norm
    onehot = F.one_hot(torch.clamp(labels, min=0), c + 1)[..., 1:].to(
        cls.dtype)
    ce = (torch.clamp(cls, min=0) - cls * onehot
          + torch.log1p(torch.exp(-torch.abs(cls))))
    p = torch.sigmoid(cls)
    p_t = onehot * p + (1 - onehot) * (1 - p)
    alpha = onehot * 0.25 + (1 - onehot) * 0.75
    cls_loss = ((1 - p_t) ** 2 * alpha * ce * cls_w[..., None]).sum() / b \
        * float(lw['rpn_cls_weight'])

    sin_p = torch.sin(box[..., 6:7]) * torch.cos(reg_targets[..., 6:7])
    sin_t = torch.cos(box[..., 6:7]) * torch.sin(reg_targets[..., 6:7])
    diff = (torch.cat([box[..., :6], sin_p], -1)
            - torch.cat([reg_targets[..., :6], sin_t], -1))
    diff = diff * torch.tensor(lw['code_weights'], dtype=diff.dtype,
                               device=diff.device)
    ad = torch.abs(diff)
    sigma2 = 9.0
    l1 = torch.where(ad <= 1 / sigma2, 0.5 * sigma2 * ad * ad,
                     ad - 0.5 / sigma2)
    loc_loss = (l1 * (pos / norm)[..., None]).sum() / b \
        * float(lw['rpn_loc_weight'])

    dir_offset = float(args.get('dir_offset', 0.78539))
    rot = reg_targets[..., 6] + anchors[None, :, 6]
    bins = torch.floor(_limit_period(rot - dir_offset, 0, 2 * math.pi)
                       / math.pi).long().clamp(0, 1)
    dce = -torch.gather(F.log_softmax(dirp, -1), -1, bins[..., None])[..., 0]
    dw = pos / torch.clamp(pos.sum(1, keepdim=True), min=1.0)
    dir_loss = (dce * dw).sum() / b * float(lw.get('rpn_dir_weight', 0.2))
    total = cls_loss + loc_loss + dir_loss
    return total, {'cls': cls_loss, 'loc': loc_loss, 'dir': dir_loss}


def onecycle(total_steps, opt):
    """(lr(step), beta1(step)) of the OneCycle schedules."""
    lr_max = float(opt['LR'])
    low = lr_max / float(opt['DIV_FACTOR'])
    m0, m1 = [float(m) for m in opt['MOMS']]
    split = int(total_steps * float(opt['PCT_START']))

    def pcts(step):
        step = min(step, total_steps)
        p1 = min(max(step / max(split, 1), 0.0), 1.0)
        p2 = min(max((step - split) / max(total_steps - split, 1), 0.0), 1.0)
        return step, p1, p2

    def lr(step):
        step, p1, p2 = pcts(step)
        if step < split:
            return lr_max + (low - lr_max) / 2 * (math.cos(math.pi * p1) + 1)
        return low / 1e4 + (lr_max - low / 1e4) / 2 * (
            math.cos(math.pi * p2) + 1)

    def mom(step):
        step, p1, p2 = pcts(step)
        if step < split:
            return m1 + (m0 - m1) / 2 * (math.cos(math.pi * p1) + 1)
        return m0 + (m1 - m0) / 2 * (math.cos(math.pi * p2) + 1)
    return lr, mom


class AdamOneCycle:
    def __init__(self, params, opt, total_steps):
        self.params = params                       # name -> leaf tensor
        self.opt = opt
        self.lr, self.mom = onecycle(total_steps, opt)
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def clip(self, grads):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        limit = float(self.opt['GRAD_NORM_CLIP'])
        if norm < limit:
            return grads
        return {k: g / norm * limit for k, g in grads.items()}

    @torch.no_grad()
    def step(self, grads):
        """One update; returns the clipped gradients."""
        grads = self.clip(grads)
        b1, b2, eps = self.mom(self.count), 0.99, 1e-8
        t = self.count + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        lr = self.lr(self.count)
        wd = float(self.opt['WEIGHT_DECAY'])
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            p.add_((u + wd * p) * -lr)
        self.count += 1
        return grads


def trained(spec):
    """Names of the trained parameters (weights, biases, BN affine)."""
    return [n for n, shape, kind, _ in spec
            if kind in ('w', 'b') or n.endswith(('.weight', '.bias'))]


def run_steps(model, anchors, params, batches, opt_cfg, total_steps,
              prec=None, keep=None):
    """`len(batches)` training steps of the reference from `params` (name
    -> tensor, copied): per step (points, mask, gt numpy).

    :param keep: optional fn(points, mask, gt) -> the part of the batch to
        step on (a planted fault)
    :return: losses [float], first clipped gradients {name: tensor},
        parameters after the steps {name: tensor}
    """
    from .net import F32
    prec = prec or F32
    names = trained(model.spec())
    p = {k: v.detach().clone() for k, v in params.items()}
    leaves = {k: p[k].requires_grad_(True) for k in names}
    adam = AdamOneCycle(leaves, opt_cfg, total_steps)
    anc = torch.as_tensor(anchors.anchors, device=next(iter(p.values()))
                          .device)
    losses, first = [], None
    for points, mask, gt in batches:
        if keep is not None:
            points, mask, gt = keep(points, mask, gt)
        lab, reg = zip(*[anchors.targets(g) for g in gt])
        dev = anc.device
        labels = torch.as_tensor(np.stack(lab), device=dev).long()
        regs = torch.as_tensor(np.stack(reg), device=dev)
        out = model.forward(p, torch.as_tensor(points, device=dev),
                            torch.as_tensor(mask, device=dev), train=True,
                            prec=prec)
        loss, _ = anchor_loss(out, anc, labels, regs, model.cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        clipped = adam.step(dict(zip(names, grads)))
        if first is None:
            first = {k: v.detach().clone() for k, v in clipped.items()}
        losses.append(float(loss.detach()))
    return losses, first, {k: leaves[k].detach() for k in names}
