"""Fault injection and the node programs that drill it (the port's copies
of the JAX package's ``testing/faults.py`` and ``testing/programs.py``)."""
