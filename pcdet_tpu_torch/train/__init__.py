"""SECOND training (trainer, train step, adam_onecycle) and the evaluation
loop."""
