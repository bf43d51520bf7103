"""Utilities of the port: `distribution` (clamped-normal sampling)."""

from . import distribution
