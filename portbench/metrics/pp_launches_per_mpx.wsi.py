"""Launches of the program's hand-written kernels over the window, from
its exact counters (``cuda_build.launch_counts``: ``cc_label``,
``hist16384``, ``watershed``, ``propagate_labels``), over the window's
Mpx."""

from portbench.readers import pp_launches_per_mpx as read  # noqa: F401
