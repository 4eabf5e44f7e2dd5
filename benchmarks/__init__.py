"""The benchmark of ``memento_tpu_torch``; run a cell with
``python3 -m benchmarks.run`` (see ``benchmarks/run.py``)."""
