"""One training step: forward, loss, backward, optimizer update.

Twin of `pcdet_tpu.train.train_state.make_train_step` for a model with a
train-mode forward and a `loss(ret, batch)` (`models.pointpillar.
PointPillar`, `models.second.SECONDNet`, `models.parta2.PartA2Net`), in
its order: the fork's `experiments.between_dataloading_and_feedforward`
hook at the TRAIN caps (under cfg.TORCH_VOXEL_GENERATOR it voxelizes the
batch's points again, so the loss reaches them; else it returns the batch
as it is), train-mode forward (the BN running statistics update in place),
the loss (`loss_with_bev` where the model has it: PointPillar adds the BEV
segmentation loss when its MODE holds 'bev'), gradients of the trained
parameters only (the optimizer's: frozen ones are left out of the
backward and the update), the optimizer update, the step count, `loss`
into the tb dict.
"""
import torch

from ..experiments import between_dataloading_and_feedforward


def loss_and_grads(model, params, batch):
    """The hook, train-mode forward, loss, backward.

    :param params: the tensors to differentiate by (the trained parameters,
        and any input the batch was made from, such as a depth map)
    :return: loss (scalar tensor), tb dict of scalar tensors, grads (one
        per tensor of `params`, in order)
    """
    batch = between_dataloading_and_feedforward(batch, model.cfg, train=True)
    model.train_mode()
    ret = model.forward(batch)
    loss, tb = getattr(model, 'loss_with_bev', model.loss)(ret, batch)
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
        self.input_grads = ()

    def train_step(self, batch, inputs=()):
        """One update on `batch`; returns the tb dict with `loss` (tensors
        on the model's device: reading them syncs).  The loss's gradients
        by `inputs` (tensors the batch was made from, differentiably) are
        kept in `input_grads`."""
        n = len(self.params)
        loss, tb, grads = loss_and_grads(self.model,
                                         list(self.params) + list(inputs),
                                         batch)
        self.input_grads = grads[n:]
        self.optimizer.step(grads[:n])
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
