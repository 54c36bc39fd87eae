"""The decoder-only LM of the serving path (dense family): layers, attention
with the flash-attention kernel, prefill/decode, and the reference's weights
carried across (``convert``)."""
