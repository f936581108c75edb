"""Serving engine: scheduler, paged KV manager and model executors."""
