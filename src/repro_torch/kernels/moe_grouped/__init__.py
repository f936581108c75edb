"""Grouped expert GEMM: the MoE feed-forward over the rows routed to each
expert."""
