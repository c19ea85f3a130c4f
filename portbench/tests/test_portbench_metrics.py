"""Each metric file's arithmetic on canned spans, counters and a canned
profiler trace; the trace summary itself."""
import pytest

from portbench.harness import load_module, summarize_trace


def _trace():
    """Two cards; card 0 busy [0, 10) and [15, 20) (a memcpy overlapping
    a kernel), card 1 busy [5, 8); host ops around the gaps (us)."""
    return [
        {"ph": "X", "cat": "kernel", "name": "void cc_phases<1>(...)",
         "ts": 0.0, "dur": 10.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "void flood_levels(FloodArgs)",
         "ts": 15.0, "dur": 4.0, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 16.0, "dur": 4.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_conv",
         "ts": 5.0, "dur": 3.0, "args": {"device": 1}},
        {"ph": "X", "cat": "user_annotation", "name": "wsi/nuclei_sets",
         "ts": 0.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero",
         "ts": 11.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ignored",
         "ts": 0.0, "dur": 99.0, "args": {"device": 0}},
        {"ph": "i", "name": "marker", "ts": 3.0},
    ]


def test_summarize_trace():
    s = summarize_trace(_trace())
    assert s["busy_s"] == {0: pytest.approx(15e-6), 1: pytest.approx(3e-6)}
    assert s["device_ops"]["Memcpy DtoH"] == pytest.approx(4e-6)
    # card 0: [10, 15) under aten::nonzero at 12.5, [20, 30) under the
    # annotation; card 1: [0, 5), [8, 30) under the annotation
    assert s["idle_gaps"]["aten::nonzero"] == pytest.approx(5e-6)
    assert s["idle_gaps"]["wsi/nuclei_sets"] == pytest.approx(37e-6)


def _run(**extra):
    units = [{"mpx": 37.748736, "flops": 2e14, "spans": {
        "Inference Time": 2.0, "Nuclei Post Proc Time": 0.5,
        "Tissue Region Post Proc Time": 0.1,
        "Gland & Lumen Post Proc Time": 0.4}},
        {"mpx": 37.748736, "flops": 2e14, "spans": {
            "Inference Time": 3.0, "Nuclei Post Proc Time": 0.5,
            "Tissue Region Post Proc Time": 0.1,
            "Gland & Lumen Post Proc Time": 0.4}}]
    run = {"setup_s": 21.5, "window_s": 8.0, "units": units,
           "window_mpx": 75.497472, "chips": 1, "peak_flops": 989e12,
           "counters": {"cc_label": 100, "hist16384": 50, "watershed": 25,
                        "propagate_labels": 1},
           "profile": {"unit": units[0], "wall_s": 4.0,
                       "busy_s": {0: 1.0},
                       "device_ops": {"void hist_kernel(int const*)": 0.002,
                                      "void ws_finish(...)": 0.003,
                                      "sm90_xmma_conv": 1.0},
                       "idle_gaps": {}}}
    run.update(extra)
    return run


@pytest.mark.parametrize("kind", ["wsi", "tile"])
def test_per_layer_readers(kind):
    run = _run()
    mfu = load_module("metrics", "mfu." + kind).read(run)
    assert mfu == pytest.approx(100 * 2e14 / 4.0 / 989e12)
    ms = load_module("metrics", "pp_kernel_ms_per_mpx." + kind).read(run)
    assert ms == pytest.approx(5.0 / 37.748736)
    launches = load_module("metrics", "pp_launches_per_mpx." + kind).read(run)
    assert launches == pytest.approx(176 / 75.497472)
    idle = load_module("metrics", "device_idle." + kind).read(run)
    assert idle == pytest.approx(75.0)
    no_trace = _run(profile=None)
    for name in ("mfu.", "pp_kernel_ms_per_mpx.", "device_idle."):
        assert load_module("metrics", name + kind).read(no_trace) is None


def test_kernel_time_is_silent_without_its_kernels():
    run = _run()
    run["profile"]["device_ops"] = {"sm90_xmma_conv": 1.0}
    assert load_module("metrics", "pp_kernel_ms_per_mpx.wsi").read(run) \
        is None


def test_span_readers():
    run = _run()
    assert load_module("metrics", "wsi_infer_s_per_mpx").read(run) == \
        pytest.approx(5.0 / 75.497472)
    assert load_module("metrics", "wsi_pp_s_per_mpx").read(run) == \
        pytest.approx(2.0 / 75.497472)
    run["units"][1]["spans"] = {}
    assert load_module("metrics", "wsi_infer_s_per_mpx").read(run) is None
    assert load_module("metrics", "wsi_pp_s_per_mpx").read(run) is None


def test_end_to_end_readers():
    run = _run()
    for name in ("wsi_mpx_per_s", "tile_mpx_per_s"):
        assert load_module("metrics", name).read(run) == \
            pytest.approx(75.497472 / 8.0)
    assert load_module("metrics", "setup_s").read(run) == 21.5
