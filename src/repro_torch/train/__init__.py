"""Training: train state, step and loop (``src/repro/train``)."""
