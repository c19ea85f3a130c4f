"""Device-idle seconds while the program's host was in the WSI gland and
lumen phase's host work on the main thread: waiting on a tissue region's
prefetched reads (``wsi/region_wait``), and each region's lumen gating
and instance records (``wsi/region_info``), over the profiled unit's
Mpx.

The profiled unit's idle gaps are named by the innermost host operation
running at their midpoint; this sums those named by ``SPANS``. None
where the run has no profile or no gap carries one of the names (a
program without these spans).
"""

SPANS = ("wsi/region_wait", "wsi/region_info")


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    gaps = [prof["idle_gaps"][name] for name in SPANS
            if name in prof["idle_gaps"]]
    if not gaps:
        return None
    return sum(gaps) / prof["unit"]["mpx"]
