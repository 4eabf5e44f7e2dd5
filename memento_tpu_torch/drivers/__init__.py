"""Scale drivers: the JAX package's benchmark scripts on the port.

One module per script of the JAX package (the repository's ``bench.py`` and
``examples/*north_star*.py``, ``examples/kernel_bench.py``), each run as

    python -m memento_tpu_torch.drivers.<name> [--device cuda]

They run on the card unless ``--device cpu`` is given, take the same
environment knobs as the script they replace, log to stderr and print one
JSON line last on stdout (``_report.py``).  Their data comes from
``_data.py``, the port's own copies of the scripts' generators (equal bit
for bit for the same seed).
"""
