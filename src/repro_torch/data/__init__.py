"""Workload synthesis for the control plane (BurstGPT-like traces)."""
