"""Serving entry points of the port (training is ROADMAP A12)."""

from repro_torch.training.serve_step import greedy_generate, make_decode_step, make_prefill

__all__ = ["make_prefill", "make_decode_step", "greedy_generate"]
