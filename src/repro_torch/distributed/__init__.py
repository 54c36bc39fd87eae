"""Data-parallel training support — the counterpart of ``repro.distributed``:
int8 error-feedback gradient compression (``compression``) and the
logical-axis sharding rules (``sharding``). The compressed data-parallel
step itself is ``train.fault_tolerance.dp_train_step_compressed``."""
