"""The LM of every family (dense, moe, ssm, hybrid, vlm; encdec in
``encdec``): layers, attention with the flash-attention kernels (forward,
and backward under grad), the Mamba2 SSD blocks (``ssm``), the experts
(``moe``), prefill/decode, the training loss, the dry-run
shape specs (``api.input_specs``), parameter trees (``tree``), and the
reference's weights carried across (``convert``)."""
