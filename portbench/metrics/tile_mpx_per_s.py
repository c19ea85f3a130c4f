"""Input pixels of every directory job the window ran, over the window's
seconds (from its opening after warm-up to the end of the first job that
ends past ``--seconds``)."""

from portbench.readers import window_rate as read  # noqa: F401
