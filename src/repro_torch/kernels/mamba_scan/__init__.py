"""Mamba-1 selective scan (see ``csrc/mamba_scan.cu``)."""
