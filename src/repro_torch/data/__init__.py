"""Synthetic pretraining data (``src/repro/data``)."""
