"""Workload synthesis for the control plane (BurstGPT-like traces) and the
synthetic token data of training."""
