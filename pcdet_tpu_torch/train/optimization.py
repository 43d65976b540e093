"""adam_onecycle: the OneCycle schedules and the optimizer update.

Twin of `pcdet_tpu.train.optimization` for `OPTIMIZER: adam_onecycle`, the
optimizer of every shipped config.  The schedules are plain float functions
of the step.  `AdamOneCycle.step` applies the optax chain of
`build_optimizer_and_schedule` as optax computes it, in order:

  1. clip_by_global_norm(GRAD_NORM_CLIP): g * (max / norm) only where the
     global norm exceeds max, as (g / norm) * max (torch's
     clip_grad_norm_ adds 1e-6 to the norm; optax does not);
  2. Adam with b1 = the scheduled momentum, b2 0.99, eps 1e-8 outside the
     square root, bias correction 1 - b ** (count + 1) with the current b1;
  3. decoupled weight decay, u + WEIGHT_DECAY * p, AFTER Adam, on every
     parameter (BN's included);
  4. u * -lr, added to the parameter.

Both schedules are read at the update count before its increment (optax's
inject_hyperparams).  Tensor math runs on the parameters' device without a
host sync (the clip is a `where`).  `adam` / `sgd` and parameter freezing
wait for the trainer that needs them.
"""
import math

import torch


def onecycle_lr_schedule(total_steps, lr_max, div_factor, pct_start):
    """step -> lr: cosine from lr_max / div_factor up to lr_max over the
    first pct_start of the steps, then down to lr_max / div_factor / 1e4."""
    low_lr = lr_max / div_factor
    split = int(total_steps * pct_start)

    def schedule(step):
        step = min(step, total_steps)
        pct1 = min(max(step / max(split, 1), 0.0), 1.0)
        pct2 = min(max((step - split) / max(total_steps - split, 1), 0.0), 1.0)
        if step < split:
            return lr_max + (low_lr - lr_max) / 2 * (math.cos(math.pi * pct1)
                                                     + 1)
        return low_lr / 1e4 + (lr_max - low_lr / 1e4) / 2 * (
            math.cos(math.pi * pct2) + 1)
    return schedule


def onecycle_mom_schedule(total_steps, moms, pct_start):
    """step -> Adam b1: cosine from moms[0] down to moms[1], then back."""
    m0, m1 = moms
    split = int(total_steps * pct_start)

    def schedule(step):
        step = min(step, total_steps)
        pct1 = min(max(step / max(split, 1), 0.0), 1.0)
        pct2 = min(max((step - split) / max(total_steps - split, 1), 0.0), 1.0)
        if step < split:
            return m1 + (m0 - m1) / 2 * (math.cos(math.pi * pct1) + 1)
        return m0 + (m1 - m0) / 2 * (math.cos(math.pi * pct2) + 1)
    return schedule


class AdamOneCycle:
    """The adam_onecycle update over a list of parameter tensors.

    :param params: tensors updated in place by `step`
    :param total_steps: the schedules' length (iterations per epoch x epochs)
    """

    def __init__(self, params, total_steps, lr, div_factor, pct_start, moms,
                 weight_decay, grad_norm_clip, b2=0.99, eps=1e-8):
        self.params = list(params)
        self.lr = onecycle_lr_schedule(total_steps, lr, div_factor, pct_start)
        self.mom = onecycle_mom_schedule(total_steps, moms, pct_start)
        self.weight_decay = float(weight_decay)
        self.max_norm = float(grad_norm_clip)
        self.b2, self.eps = b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @classmethod
    def from_config(cls, params, optim_cfg, total_steps):
        """From a config's `MODEL.TRAIN.OPTIMIZATION` (adam_onecycle only)."""
        if optim_cfg.OPTIMIZER != 'adam_onecycle':
            raise NotImplementedError('optimizer %r is not ported'
                                      % optim_cfg.OPTIMIZER)
        return cls(params, total_steps, float(optim_cfg.LR),
                   float(optim_cfg.DIV_FACTOR), float(optim_cfg.PCT_START),
                   list(optim_cfg.MOMS), float(optim_cfg.WEIGHT_DECAY),
                   float(optim_cfg.GRAD_NORM_CLIP))

    @torch.no_grad()
    def step(self, grads):
        """One update from `grads` (one per parameter, same order)."""
        grads = list(grads)
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < self.max_norm
        grads = [torch.where(keep, g, g / norm * self.max_norm)
                 for g in grads]
        b1 = self.mom(self.count)
        lr = self.lr(self.count)
        t = self.count + 1
        bc1, bc2 = 1 - b1 ** t, 1 - self.b2 ** t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - self.b2) * torch.square(g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -lr)
        self.count += 1
