"""The benchmark's independent reference engine: minigraph in Python.

A frozen copy of the JAX package's host modules (graph reader,
minimizer sketch and index, seed collection, linear and graph chaining
with the long-join rescue, GWFA bridging, chain selection, mapq, GAF),
which follow minigraph's C line by line, with the native library
replaced by a stub (`utils/native.py`), so that every stage takes its
pure-Python path.  It shares no code with what the port runs (its CUDA
front and its native tail), imports neither JAX nor either package, and
is slow: the harness holds a sample of each run's queries to it
(`portbench/indep.py`).  Branches that reach the native library or a
device return early or are never taken here.
"""
