"""LM training for the ported families (dense, ssm, hybrid; any parameter
tree): optimizers, the train step, checkpoints and the resilient train loop
(the counterpart of ``repro.train``)."""
