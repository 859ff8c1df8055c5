"""Share of the traced window in which no kernel, copy or fill ran on the card."""
from portbench.harness.readers import device_idle as read  # noqa: F401
