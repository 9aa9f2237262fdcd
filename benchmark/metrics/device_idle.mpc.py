"""device_idle.mpc (%): the share of the traced call in which no device operation ran."""

from harness.readers import device_idle as read  # noqa: F401
