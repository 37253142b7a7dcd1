"""Fused predict + acquisition over the anchor grid (see ``csrc/acq_score.cu``)."""
