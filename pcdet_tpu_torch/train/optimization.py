"""Optimizers and learning-rate schedules, twins of the optax chains of
`pcdet_tpu.train.optimization.build_optimizer_and_schedule`.

Every optimizer applies, in optax's order (written by hand: torch.optim
orders its operations otherwise):

  1. clip_by_global_norm(GRAD_NORM_CLIP) over the trained parameters:
     (g / norm) * max only where the global norm reaches max (torch's
     clip_grad_norm_ adds 1e-6 to the norm; optax does not);
  2. the update of its kind:
     - adam_onecycle: Adam with b1 = the scheduled momentum, b2 0.99, eps
       1e-8 outside the square root, bias correction 1 - b ** (count + 1)
       with the current b1; then decoupled weight decay, u + WEIGHT_DECAY
       * p, AFTER Adam, on every trained parameter (BN's included);
     - adam: L2, g + WEIGHT_DECAY * p, BEFORE Adam with b1 0.9, b2 0.999,
       eps 1e-8;
     - sgd: L2 as adam's, then the momentum trace t = g + MOMENTUM * t (no
       dampening, no Nesterov), the update t;
  3. u * -lr, added to the parameter.

The schedules are plain float functions of the step, read at the update
count before its increment (optax's inject_hyperparams).  An optimizer is
built without parameters and bound to them by `init(named_params)`, as an
optax transformation is; parameters under a frozen prefix (whole name
components: 'vfe' freezes 'vfe.pfn_layers.0.linear.weight', not
'vfe_extra.w') are left out: no update, no weight decay, no share of the
clip's norm (optax's multi_transform to set_to_zero).  Tensor math runs on
the parameters' device without a host sync (the clip is a `where`).
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


def step_decay_lr_schedule(base_lr, decay_step_list, total_iters_each_epoch,
                           lr_decay, lr_clip):
    """step -> lr: base_lr times lr_decay for each epoch of
    `decay_step_list` reached, never below lr_clip."""
    decay_steps = [x * total_iters_each_epoch for x in decay_step_list]

    def schedule(step):
        decay = 1.0
        for ds in decay_steps:
            if step >= ds:
                decay *= lr_decay
        return base_lr * max(decay, lr_clip / base_lr)
    return schedule


def warmup_cosine_lr_schedule(base_lr, eta_min, t_max):
    """step -> lr: cosine from eta_min up to base_lr over t_max steps."""
    def schedule(step):
        return eta_min + (base_lr - eta_min) * (
            1 - math.cos(math.pi * step / t_max)) / 2
    return schedule


def is_frozen(name, frozen_prefixes):
    """Whether parameter `name` lies under one of `frozen_prefixes`, by
    whole '.'-separated components."""
    return any(name == p or name.startswith(p + '.') for p in frozen_prefixes)


class Optimizer:
    """Clip, the subclass's update, -lr; see the module docstring.

    :param lr: step -> learning rate
    :param grad_norm_clip: the global norm's bound
    :param frozen_prefixes: parameter name prefixes left out by `init`
    """
    kind = None
    slots = ()

    def __init__(self, lr, grad_norm_clip, frozen_prefixes=()):
        self.lr = lr
        self.max_norm = float(grad_norm_clip)
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.count = 0
        self.params, self.names, self.frozen = [], [], []
        self.state = {}

    def init(self, named_params):
        """Bind to `named_params`, (name, tensor) pairs; zero the state and
        the count."""
        named = list(named_params)
        keep = [(n, p) for n, p in named
                if not is_frozen(n, self.frozen_prefixes)]
        self.names = [n for n, _ in keep]
        self.params = [p for _, p in keep]
        self.frozen = [n for n, _ in named
                       if is_frozen(n, self.frozen_prefixes)]
        self.count = 0
        self.state = {s: [torch.zeros_like(p) for p in self.params]
                      for s in self.slots}
        return self

    def clip(self, grads):
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, g / norm * self.max_norm) for g in grads]

    def update(self, i, p, g):
        """The update of parameter i before -lr; advances its state."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads):
        """One update from `grads` (one per trained parameter, in order)."""
        grads = self.clip(list(grads))
        self.begin_step()
        lr = self.lr(self.count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            p.add_(self.update(i, p, g) * -lr)
        self.count += 1

    def begin_step(self):
        """Per-step hyperparameters, read at `count`."""

    def state_dict(self):
        """{'optimizer', 'count', 'names', 'state': {slot: {name: tensor}}}
        (the tensors themselves, not copies)."""
        return {'optimizer': self.kind, 'count': self.count,
                'names': list(self.names),
                'state': {s: dict(zip(self.names, v))
                          for s, v in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, sd):
        """Copy a `state_dict` of an optimizer of the same kind over the
        same trained parameters into this one's tensors."""
        if sd['optimizer'] != self.kind or list(sd['names']) != self.names:
            raise ValueError('optimizer state of %r over %d parameters does '
                             'not fit %r over %d' % (
                                 sd['optimizer'], len(sd['names']), self.kind,
                                 len(self.names)))
        for s, tensors in self.state.items():
            for n, t in zip(self.names, tensors):
                t.copy_(sd['state'][s][n])
        self.count = int(sd['count'])


class Adam(Optimizer):
    """L2 into the gradient, then Adam (b1 0.9, b2 0.999)."""
    kind = 'adam'
    slots = ('mu', 'nu')

    def __init__(self, lr, weight_decay, grad_norm_clip, frozen_prefixes=(),
                 b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(lr, grad_norm_clip, frozen_prefixes)
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    def begin_step(self):
        t = self.count + 1
        self.bc1, self.bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t

    def adam(self, i, g):
        mu, nu = self.state['mu'][i], self.state['nu'][i]
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * torch.square(g) + self.b2 * nu)
        return (mu / self.bc1) / (torch.sqrt(nu / self.bc2) + self.eps)

    def update(self, i, p, g):
        return self.adam(i, g + self.weight_decay * p)


class AdamOneCycle(Adam):
    """Adam with the OneCycle momentum as b1 (b2 0.99), then decoupled
    weight decay, at the OneCycle lr."""
    kind = 'adam_onecycle'

    def __init__(self, total_steps, lr, div_factor, pct_start, moms,
                 weight_decay, grad_norm_clip, b2=0.99, eps=1e-8,
                 frozen_prefixes=()):
        super().__init__(
            onecycle_lr_schedule(total_steps, lr, div_factor, pct_start),
            weight_decay, grad_norm_clip, frozen_prefixes, b2=b2, eps=eps)
        self.mom = onecycle_mom_schedule(total_steps, moms, pct_start)

    def begin_step(self):
        self.b1 = self.mom(self.count)
        super().begin_step()

    def update(self, i, p, g):
        return self.adam(i, g) + self.weight_decay * p


class SGD(Optimizer):
    """L2 into the gradient, then the momentum trace."""
    kind = 'sgd'
    slots = ('trace',)

    def __init__(self, lr, weight_decay, momentum, grad_norm_clip,
                 frozen_prefixes=()):
        super().__init__(lr, grad_norm_clip, frozen_prefixes)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)

    def update(self, i, p, g):
        t = self.state['trace'][i]
        t.copy_(g + self.weight_decay * p + self.momentum * t)
        return t


def build_optimizer_and_schedule(optim_cfg, iters_each_epoch, epochs,
                                 frozen_prefixes=()):
    """(optimizer, lr schedule) of `MODEL.TRAIN.OPTIMIZATION`; bind the
    optimizer with `init(module.named_parameters())`.  OneCycle spans
    iters_each_epoch * epochs steps; adam / sgd decay their lr at the
    epochs of DECAY_STEP_LIST (LR_WARMUP is not applied, as in
    `pcdet_tpu`)."""
    name = optim_cfg.OPTIMIZER
    if name == 'adam_onecycle':
        opt = AdamOneCycle(
            iters_each_epoch * epochs, float(optim_cfg.LR),
            float(optim_cfg.DIV_FACTOR), float(optim_cfg.PCT_START),
            list(optim_cfg.MOMS), float(optim_cfg.WEIGHT_DECAY),
            float(optim_cfg.GRAD_NORM_CLIP), frozen_prefixes=frozen_prefixes)
        return opt, opt.lr
    if name not in ('adam', 'sgd'):
        raise NotImplementedError('optimizer %r' % name)
    lr = step_decay_lr_schedule(
        float(optim_cfg.LR), list(optim_cfg.DECAY_STEP_LIST),
        iters_each_epoch, float(optim_cfg.LR_DECAY), float(optim_cfg.LR_CLIP))
    if name == 'adam':
        opt = Adam(lr, float(optim_cfg.WEIGHT_DECAY),
                   float(optim_cfg.GRAD_NORM_CLIP), frozen_prefixes)
    else:
        opt = SGD(lr, float(optim_cfg.WEIGHT_DECAY),
                  float(optim_cfg.MOMENTUM), float(optim_cfg.GRAD_NORM_CLIP),
                  frozen_prefixes)
    return opt, lr
