"""Tensor ops and the two Hopper kernels of the serving forward
(fused_block: the encoder block; fused_decoder: the decoder body)."""
