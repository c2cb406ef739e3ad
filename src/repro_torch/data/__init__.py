"""Synthetic data pipelines (numpy copies of ``repro.data``)."""
