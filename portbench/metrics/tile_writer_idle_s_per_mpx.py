"""Device-idle seconds while the program's host was in the tile engine's
writer (``tile/write``: each image's overlay and ``.mat`` files), over
the profiled unit's Mpx.

The profiled unit's idle gaps are named by the innermost host operation
running at their midpoint; this sums those named by ``SPANS``. None
where the run has no profile or no gap carries one of the names (a
program without these spans).
"""

SPANS = ("tile/write",)


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    gaps = [prof["idle_gaps"][name] for name in SPANS
            if name in prof["idle_gaps"]]
    if not gaps:
        return None
    return sum(gaps) / prof["unit"]["mpx"]
