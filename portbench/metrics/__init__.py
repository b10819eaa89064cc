"""One reader per per-layer metric, found by the metric's name: NEEDS
names the parts of the trace it reads (portbench/trace.py), read(trace)
returns the number, or None where the trace holds nothing to read."""
