"""The decoder-only LM (dense family): layers, attention with the
flash-attention kernels (forward, and backward under grad), prefill/decode,
the training loss, parameter trees (``tree``), and the reference's weights
carried across (``convert``)."""
