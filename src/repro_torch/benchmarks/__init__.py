"""The paper's experiments on the port, from the top-level ``benchmarks``
package: the harness (``common.py``), tables 1-4 (``tables.py``) and
figures 2-4 (``figures.py``).  Importing runs nothing."""
