"""The port's plugin tasks."""
