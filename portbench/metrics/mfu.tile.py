"""The whole step's share of the chips' peak, in %: the configuration's
forward FLOPs for the windows the profiled unit's inputs need (the
reference's own count of the full published forward, a window at a
time), over the profiled unit's wall seconds, over 989 TFLOP/s (H100
SXM, dense bf16) times the chips."""

from portbench.readers import mfu as read  # noqa: F401
