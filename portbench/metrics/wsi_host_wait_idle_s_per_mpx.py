"""Device-idle seconds while the program's host was in the resident WSI
loop, its main thread waiting on the host threads: the disk canvas's
landing (``wsi/land_wait``) and the grid tiles' records
(``wsi/records_wait``), over the profiled unit's Mpx.

The profiled unit's idle gaps are named by the innermost host operation
running at their midpoint; this sums those named by ``SPANS``. None
where the run has no profile or no gap carries one of the names (a
program without these spans).
"""

SPANS = ("wsi/land_wait", "wsi/records_wait")


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    gaps = [prof["idle_gaps"][name] for name in SPANS
            if name in prof["idle_gaps"]]
    if not gaps:
        return None
    return sum(gaps) / prof["unit"]["mpx"]
