"""The decoder-only LM (dense, ssm and hybrid families): layers, attention
with the flash-attention kernels (forward, and backward under grad), the
Mamba2 SSD blocks (``ssm``), prefill/decode, the training loss, the dry-run
shape specs (``api.input_specs``), parameter trees (``tree``), and the
reference's weights carried across (``convert``)."""
