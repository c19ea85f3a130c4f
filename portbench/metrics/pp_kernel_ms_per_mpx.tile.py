"""Device time of the program's hand-written post-processing kernels
(``csrc/cc_label.cu``, ``hist16384.cu``, ``watershed.cu``), found by
their kernel names in the profiled unit's trace, in ms over the unit's
Mpx."""

from portbench.readers import pp_kernel_ms_per_mpx as read  # noqa: F401
