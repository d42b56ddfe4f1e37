"""Traffic: the jobs a cell repeats (``<name>.json``), the one generator
of their inputs (``generate.py``) and its data models (``fixed.py``)."""
