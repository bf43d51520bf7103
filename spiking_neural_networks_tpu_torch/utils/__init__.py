"""Utilities of the port: `distribution` (clamped-normal sampling),
`checkpoint` (save and resume lattices and networks) and `profiling` (step
timers, profiler traces)."""

from . import checkpoint, distribution, profiling
