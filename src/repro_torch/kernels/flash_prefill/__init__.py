"""Causal (optionally windowed) flash prefill attention."""
