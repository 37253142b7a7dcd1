"""Matérn-5/2 ARD gram and cross-row kernels (see ``csrc/matern52.cu``)."""
