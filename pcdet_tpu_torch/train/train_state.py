"""One training step: forward, loss, backward, optimizer update.

Twin of `pcdet_tpu.train.train_state.make_train_step` for a model with a
train-mode forward and a `loss(ret, batch)` (`models.second.SECONDNet`).
The BN running statistics update in place during the forward.  The fork's
`between_dataloading_and_feedforward` hook is a no-op for the shipped
configs and is not called here.
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
    """Model, its parameters in a fixed order, optimizer and step count."""

    def __init__(self, model, optimizer):
        self.model = model
        self.params = optimizer.params
        self.optimizer = optimizer
        self.step = 0

    def train_step(self, batch):
        """One update on `batch`; returns the tb dict with `loss` (tensors
        on the model's device: reading them syncs)."""
        loss, tb, grads = loss_and_grads(self.model, self.params, batch)
        self.optimizer.step(grads)
        self.step += 1
        tb['loss'] = loss
        return tb
