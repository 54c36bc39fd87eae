"""LM training for the dense family: optimizers, the train step, checkpoints
and the resilient train loop (the counterpart of ``repro.train``)."""
