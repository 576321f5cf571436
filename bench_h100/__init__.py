"""The port's benchmark harness on the H100 (``python bench_h100/run.py``)."""
