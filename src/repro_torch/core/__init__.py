"""Timing, metrics and the task abstraction."""
