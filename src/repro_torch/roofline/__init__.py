"""The roofline of the port: H100 constants (``hw.py``) and the
three-term model of a step (``analysis.py``)."""
