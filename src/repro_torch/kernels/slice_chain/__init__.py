"""The GPHP slice-sampling chain in one launch (see ``csrc/slice_chain.cu``)."""
