"""One training step: forward, loss, backward, optimizer update.

Twin of `pcdet_tpu.train.train_state.make_train_step` for a model with a
train-mode forward and a `loss(ret, batch)` (`models.pointpillar.
PointPillar`, `models.second.SECONDNet`, `models.parta2.PartA2Net`), in
its order: train-mode forward
(the BN running statistics update in place), loss, gradients of the
trained parameters only (the optimizer's: frozen ones are left out of the
backward and the update), the optimizer update, the step count, `loss`
into the tb dict.  The fork's `between_dataloading_and_feedforward` hook
is a no-op for the shipped configs and is not called here.
"""
import torch


def loss_and_grads(model, params, batch):
    """Train-mode forward, loss, backward.

    :return: loss (scalar tensor), tb dict of scalar tensors, grads (one
        per parameter of `params`, in order)
    """
    model.train_mode()
    ret = model.forward(batch)
    loss, tb = model.loss(ret, batch)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), {k: v.detach() for k, v in tb.items()}, grads


class TrainState:
    """Model, its optimizer (bound to the trained parameters), the step
    count (`it`, the updates made) and the generator the model draws from
    in training (None for a model that draws nothing)."""

    def __init__(self, model, optimizer, generator=None):
        self.model = model
        self.params = optimizer.params
        self.optimizer = optimizer
        self.generator = generator
        self.step = 0

    def train_step(self, batch):
        """One update on `batch`; returns the tb dict with `loss` (tensors
        on the model's device: reading them syncs)."""
        loss, tb, grads = loss_and_grads(self.model, self.params, batch)
        self.optimizer.step(grads)
        self.step += 1
        tb['loss'] = loss
        return tb

    def state_dict(self):
        """{'it', 'model_state' (the module's reference-keyed state_dict),
        'optimizer_state'} and, with a generator, 'rng_state' (its
        `get_state()`, so that a resumed run draws what the uninterrupted
        one would): the live tensors, not copies."""
        sd = {'it': self.step,
              'model_state': self.model.module.state_dict(),
              'optimizer_state': self.optimizer.state_dict()}
        if self.generator is not None:
            sd['rng_state'] = self.generator.get_state()
        return sd

    def load_state_dict(self, sd):
        """Copy a `state_dict` into this state's tensors (and generator)."""
        self.model.module.load_state_dict(sd['model_state'])
        self.optimizer.load_state_dict(sd['optimizer_state'])
        if self.generator is not None and 'rng_state' in sd:
            self.generator.set_state(sd['rng_state'].cpu())
        self.step = int(sd['it'])
