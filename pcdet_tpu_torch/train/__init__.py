"""SECOND training: trainer, train step, adam_onecycle."""
