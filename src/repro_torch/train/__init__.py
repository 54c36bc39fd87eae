"""LM training for every family (any parameter tree): optimizers, the train step, checkpoints and the resilient train loop
(the counterpart of ``repro.train``)."""
