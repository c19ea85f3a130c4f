"""Slide area at the processing resolution of every slide the window ran,
over the window's seconds (from its opening after warm-up to the end of
the first slide that ends past ``--seconds``)."""

from portbench.readers import window_rate as read  # noqa: F401
