"""Synthetic training data (the port's copy of ``repro.data``)."""
