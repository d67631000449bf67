"""Evaluation of the port (metrics so far)."""
