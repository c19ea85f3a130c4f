"""Steerable-filter kernel syntheses over the window: the slides' logged
``Steerable Kernel Syntheses`` (the program's count of G-conv kernels
built from their circular-harmonic bases, one a G-convolution a forward),
summed over the window's slides, over their Mpx. None where no slide
logged the count (a model without G-convolutions, or a program that does
not count them)."""


def read(run):
    counts = [u["spans"]["Steerable Kernel Syntheses"] for u in run["units"]
              if "Steerable Kernel Syntheses" in u["spans"]]
    if not counts:
        return None
    return sum(counts) / run["window_mpx"]
