"""The share of the profiled unit's wall seconds in which no operation
ran on the device, in %, the mean over the chips used (each card's share
is on an earlier line of the run's standard error)."""

from portbench.readers import device_idle as read  # noqa: F401
