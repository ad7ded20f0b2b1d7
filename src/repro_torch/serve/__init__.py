"""Serving substrate: prefill / decode steps with a KV cache."""

from repro_torch.serve.serve_step import make_serve_step, make_prefill_step, greedy_sample  # noqa: F401
