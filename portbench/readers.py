"""Readers that several metric files share: each takes a run's record
(``harness.run_cell``) and returns one number, or None where the run
recorded nothing to read. A metric file names one of these as its
``read``, or holds a reader of its own."""

# the program's hand-written post-processing kernels (csrc/cc_label.cu,
# hist16384.cu, watershed.cu) by their kernel names
PP_KERNELS = ("cc_phases", "hist_kernel", "ws_minmax", "tile_init",
              "flood_levels", "ws_finish")


def window_rate(run):
    """The window's Mpx over its seconds."""
    return run["window_mpx"] / run["window_s"]


def device_idle(run):
    """The share of the profiled unit's wall seconds in which no operation
    ran on the device, in %, the mean over the chips used."""
    prof = run["profile"]
    if not prof or not prof["busy_s"] or prof["wall_s"] <= 0:
        return None
    busy = [prof["busy_s"].get(d, 0.0) for d in range(run["chips"])]
    return 100.0 * (1.0 - sum(busy) / len(busy) / prof["wall_s"])


def mfu(run):
    """The profiled unit's forward FLOPs (the reference's count) over its
    wall seconds, over the chips' peak, in %."""
    prof = run["profile"]
    if not prof or prof["wall_s"] <= 0:
        return None
    return 100.0 * prof["unit"]["flops"] / prof["wall_s"] / run["peak_flops"]


def pp_kernel_ms_per_mpx(run):
    """Device ms of the post-processing kernels in the profiled unit over
    its Mpx."""
    prof = run["profile"]
    if not prof:
        return None
    times = [t for name, t in prof["device_ops"].items()
             if any(k in name for k in PP_KERNELS)]
    if not times:
        return None
    return 1e3 * sum(times) / prof["unit"]["mpx"]


def pp_launches_per_mpx(run):
    """The program's kernel launch counters over the window, over its
    Mpx."""
    counters = run["counters"]
    if not counters:
        return None
    return sum(counters.values()) / run["window_mpx"]
