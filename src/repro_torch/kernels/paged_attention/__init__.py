"""Paged decode attention."""
