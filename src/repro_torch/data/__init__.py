"""Deterministic synthetic data, drawn from numpy generators."""
