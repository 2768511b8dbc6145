"""The benchmark's own code: cells, traffic, weights, the serving loop
and its spans, the trace's reduction, the work a step needs, and the
check that decides ``correct``.  Imports nothing of the program at module
level; :mod:`harness.serve` imports it when a run starts."""
