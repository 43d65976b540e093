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

Under a process group (`parallel.ddp`; JAX's data mesh) each rank's loss
is its share of the global batch's, the parameter gradients are summed
over the ranks between the backward and the update (XLA's psum), and
after the update every rank takes rank 0's BatchNorm running statistics,
so that all ranks hold one state.  The tb dict stays the rank's own
shares and counts (`ddp.reduce_tb` sums them where they are logged).
"""
import torch

from ..experiments import between_dataloading_and_feedforward
from ..parallel import ddp
from ..utils.profiler import span


def loss_and_grads(model, params, batch):
    """The hook, train-mode forward and loss (the span `pcdet.forward`),
    backward (`pcdet.backward`).

    :param params: the tensors to differentiate by (the trained parameters,
        and any input the batch was made from, such as a depth map)
    :return: loss (scalar tensor), tb dict of scalar tensors, grads (one
        per tensor of `params`, in order)
    """
    with span('pcdet.forward'):
        batch = between_dataloading_and_feedforward(batch, model.cfg,
                                                    train=True)
        model.train_mode()
        ret = model.forward(batch)
        loss, tb = getattr(model, 'loss_with_bev', model.loss)(ret, batch)
    with span('pcdet.backward'):
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), {k: v.detach() for k, v in tb.items()}, grads


class TrainState:
    """Model, its optimizer (bound to the trained parameters), the step
    count (`it`, the updates made), the generator the model draws from
    in training (None for a model that draws nothing) and the process
    group whose ranks share the global batch (None: this process alone)."""

    def __init__(self, model, optimizer, generator=None, process_group=None):
        self.model = model
        self.params = optimizer.params
        self.optimizer = optimizer
        self.generator = generator
        self.process_group = process_group
        self.step = 0
        self.input_grads = ()

    def loss_and_grads(self, batch, inputs=()):
        """`loss_and_grads` with the parameter gradients summed over the
        ranks; the loss's gradients by `inputs` are kept, the rank's own,
        in `input_grads`."""
        n = len(self.params)
        loss, tb, grads = loss_and_grads(self.model,
                                         list(self.params) + list(inputs),
                                         batch)
        self.input_grads = grads[n:]
        return loss, tb, ddp.all_reduce_grads(grads[:n], self.process_group)

    def train_step(self, batch, inputs=()):
        """One update on `batch`; returns the tb dict with `loss` (tensors
        on the model's device: reading them syncs).  The loss's gradients
        by `inputs` (tensors the batch was made from, differentiably) are
        kept in `input_grads`."""
        loss, tb, grads = self.loss_and_grads(batch, inputs)
        with span('pcdet.optimizer'):
            self.optimizer.step(grads)
            ddp.broadcast_buffers(self.model.module, self.process_group)
        self.step += 1
        tb['loss'] = loss
        return tb

    def state_dict(self):
        """{'it', 'model_state' (the module's reference-keyed state_dict),
        'optimizer_state'} and, with a generator, 'rng_state' (its
        `get_state()`, so that a resumed run draws what the uninterrupted
        one would) and, under a process group of several ranks,
        'rng_states', every rank's in rank order (a collective: every rank
        calls it): the live tensors, not copies."""
        sd = {'it': self.step,
              'model_state': self.model.module.state_dict(),
              'optimizer_state': self.optimizer.state_dict()}
        if self.generator is not None:
            sd['rng_state'] = self.generator.get_state()
            if ddp.world_size(self.process_group) > 1:
                sd['rng_states'] = ddp.all_gather_object(
                    sd['rng_state'], self.process_group)
        return sd

    def load_state_dict(self, sd):
        """Copy a `state_dict` into this state's tensors (and generator:
        this rank's state of 'rng_states', or 'rng_state' on rank 0 where
        the file holds no state for this rank)."""
        self.model.module.load_state_dict(sd['model_state'])
        self.optimizer.load_state_dict(sd['optimizer_state'])
        if self.generator is not None:
            r = ddp.rank(self.process_group)
            states = sd.get('rng_states') or []
            state = (states[r] if r < len(states)
                     else sd.get('rng_state') if r == 0 else None)
            if state is not None:
                self.generator.set_state(state.cpu())
        self.step = int(sd['it'])
