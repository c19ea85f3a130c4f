"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
where CUDA is absent; on a GPU machine run
``python -m pytest tests/test_torch_cuda.py -q``. Outputs must be exact:
every kernel computes an integer fixed point with a deterministic contract.
"""
import numpy as np
import pytest
import torch

from cerberus_tpu_torch.ops import cuda_build
from cerberus_tpu_torch.ops import device_postproc as D
from cerberus_tpu_torch.ops import gpu_postproc as G
from cerberus_tpu_torch.ops.cc_label import (
    connected_components,
    connected_components_plain,
)
from cerberus_tpu_torch.ops.hist16384 import hist16384, hist16384_plain
from cerberus_tpu_torch.ops.watershed import (
    propagate_labels,
    propagate_labels_plain,
    watershed,
    watershed_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build_all()
    return torch.device("cuda")


def _blob_prob(hw, n, seed, rmin=4, rmax=14):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = r.integers(0, hw[0]), r.integers(0, hw[1])
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r.uniform(rmin, rmax)
        prob = np.maximum(prob, np.clip(1 - d, 0, 1).astype(np.float32))
    return prob


def _spiral(n):
    mask = np.zeros((n, n), bool)
    t, l, b, r = 0, 0, n - 1, n - 1
    while t <= b and l <= r:
        mask[t, l:r + 1] = mask[b, l:r + 1] = True
        mask[t:b + 1, r] = True
        mask[t + 2:b + 1, l] = True
        if t + 2 <= b:
            mask[t + 2, l:r - 1] = True
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    return mask


@pytest.mark.parametrize("hw,density", [((600, 600), 0.5), ((1000, 1000), 0.3),
                                        ((37, 1029), 0.6)])
def test_cc_label_matches_plain(dev, hw, density):
    mask = torch.from_numpy(np.random.default_rng(0).random(hw) < density)
    mask = mask.to(dev)
    got = connected_components(mask)
    torch.cuda.synchronize()
    assert torch.equal(got, connected_components_plain(mask))


def test_cc_label_spiral(dev):
    m = torch.from_numpy(_spiral(301)).to(dev)
    got = connected_components(m)
    assert torch.equal(got, connected_components_plain(m))
    assert int(got[m].unique().numel()) == 1


def test_hist16384_matches_plain(dev):
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        -5, 16400, (1000, 1000)).astype(np.int32)).to(dev)
    ids[:500] = 0  # mostly-background plane: contention on bin 0
    assert torch.equal(hist16384(ids), hist16384_plain(ids))


def _cc_case(name):
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros((130, 200), bool)
    if name == "full":
        return np.ones((130, 200), bool)
    if name == "ring1002":  # a background plane as fill_holes pads it
        bg = _blob_prob((1000, 1000), 600, seed=5, rmin=3, rmax=12) <= 0.5
        return np.pad(bg, 1, constant_values=True)
    if name == "spiral1000":
        return _spiral(1000)
    h, w = (int(v) for v in name.split("x"))
    return rng.random((h, w)) < 0.55


@pytest.mark.parametrize("name", ["63x65", "1x513", "513x1", "37x1029",
                                  "130x130", "32x128", "33x129", "empty",
                                  "full", "ring1002", "spiral1000"])
def test_cc_label_edge_shapes_match_plain(dev, name):
    """Planes that the 32 x 128 tiles cut at every edge, a plane of exactly
    one tile, and planes with one large component."""
    mask = torch.from_numpy(_cc_case(name)).to(dev)
    cuda_build.reset_launch_counts()
    got = connected_components(mask)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["cc_label"] == 1
    assert torch.equal(got, connected_components_plain(mask))
    if name == "ring1002":
        assert int(got[0, 0]) == 1 and int((got == 1).sum()) >= 4 * 1001


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_cc_label_unaligned_mask(dev, offset):
    """Rows that start off a 16-byte boundary, in a buffer that does too."""
    h, w = 150, 203
    flat = torch.from_numpy(np.random.default_rng(offset).random(
        offset + h * w) < 0.6).to(dev)
    mask = flat[offset:].view(h, w)
    assert mask.is_contiguous() and mask.data_ptr() % 16 == offset % 16
    got = connected_components(mask)
    assert torch.equal(got, connected_components_plain(mask.clone()))


def test_cc_label_zero_size(dev):
    cuda_build.reset_launch_counts()
    got = connected_components(torch.zeros((0, 7), dtype=torch.bool,
                                           device=dev))
    assert got.shape == (0, 7) and got.dtype == torch.int32


@pytest.mark.parametrize("n_live", [1, 2, 257, 16384])
@pytest.mark.parametrize("inside", [True, False])
def test_hist16384_n_live(dev, n_live, inside):
    rng = np.random.default_rng(n_live + inside)
    ids = rng.integers(0, n_live, (1000, 1000)).astype(np.int32)
    ids[300:] = 0  # long runs of one id, as in a label plane
    if not inside:
        ids[::5, ::3] = rng.integers(-9, 16400, ids[::5, ::3].shape)
    ids = torch.from_numpy(ids).to(dev)
    assert torch.equal(hist16384(ids, n_live), hist16384_plain(ids))


@pytest.mark.parametrize("offset,numel", [(0, 0), (0, 1), (1, 2), (1, 7),
                                          (2, 4099), (3, 1000001),
                                          (0, 1000003), (1, 1002 * 333)])
def test_hist16384_unaligned_and_ragged(dev, offset, numel):
    """A base pointer off a 16-byte boundary and a length that is no
    multiple of 4: the ids around the aligned body are counted one by one."""
    flat = torch.from_numpy(np.random.default_rng(numel).integers(
        0, 900, offset + numel).astype(np.int32)).to(dev)
    ids = flat[offset:]
    assert ids.data_ptr() % 16 == 4 * offset
    for n_live in (900, 16384):
        got = hist16384(ids, n_live)
        assert torch.equal(got, hist16384_plain(ids.clone()))
        assert int(got.sum()) == numel


def test_hist16384_all_ids_equal(dev):
    ids = torch.full((777, 1001), 5, dtype=torch.int32, device=dev)
    got = hist16384(ids, 6)
    assert int(got[5]) == ids.numel() and int(got.sum()) == ids.numel()


def test_watershed_matches_plain(dev):
    prob = _blob_prob((512, 640), 300, seed=2)
    prob = np.round(prob * 16) / 16
    image = torch.from_numpy(-prob).to(dev)
    markers = connected_components(torch.from_numpy(prob > 0.6).to(dev))
    mask = torch.from_numpy(prob > 0.1).to(dev)
    got = watershed(image, markers, mask)
    assert torch.equal(got, watershed_plain(image, markers, mask))
    allowed = mask.contiguous()
    cuda_build.reset_launch_counts()
    assert torch.equal(propagate_labels(markers, allowed),
                       propagate_labels_plain(markers, allowed))
    assert cuda_build.launch_counts["propagate_labels"] == 1
    assert cuda_build.launch_counts["watershed"] == 0


def _flood_case(name):
    """(image, markers, mask) as numpy for the flood's edge cases."""
    rng = np.random.default_rng(len(name))
    if name == "spiral301":
        mask = _spiral(301)
        ys, xs = np.nonzero(mask)
        markers = np.zeros(mask.shape, np.int32)
        markers[0, 0] = 7  # the outer end of the corridor
        inner = np.argmax(np.abs(ys - 150) + np.abs(xs - 150) == (
            np.abs(ys - 150) + np.abs(xs - 150)).min())
        markers[ys[inner], xs[inner]] = 3  # the inner end
        return np.zeros(mask.shape, np.float32), markers, mask
    if name == "blobs1000":
        prob = _blob_prob((1000, 1000), 600, seed=4, rmin=3, rmax=12)
        markers = connected_components_plain(torch.from_numpy(prob > 0.6))
        return -prob, markers.numpy(), prob > 0.1
    hw = {"ragged37x1029": (37, 1029), "row1x513": (1, 513),
          "col513x1": (513, 1)}.get(name, (150, 190))
    image = np.round(rng.random(hw) * 6).astype(np.float32)
    mask = rng.random(hw) < 0.85
    markers = np.where(rng.random(hw) < 0.01,
                       rng.integers(1, hw[0] * hw[1] + 2, hw), 0)
    markers = markers.astype(np.int32)
    if name == "constant":
        image[:] = 0.5
    elif name == "empty_mask":
        mask[:] = False
    elif name == "no_markers":
        markers[:] = 0
    elif name == "markers_outside_mask":
        markers[mask] = 0
        markers[~mask] = rng.integers(1, 50, int((~mask).sum()))
    return image, markers, mask


@pytest.mark.parametrize("name", [
    "constant", "spiral301", "ragged37x1029", "row1x513", "col513x1",
    "empty_mask", "no_markers", "markers_outside_mask", "blobs1000"])
def test_flood_entries_match_plain(dev, name):
    image, markers, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in _flood_case(name))
    cuda_build.reset_launch_counts()
    got = watershed(image, markers, mask)
    assert cuda_build.launch_counts["watershed"] == 1
    assert torch.equal(got, watershed_plain(image, markers, mask))
    got = propagate_labels(markers, mask)
    assert cuda_build.launch_counts["propagate_labels"] == 1
    assert cuda_build.launch_counts["watershed"] == 1
    assert torch.equal(got, propagate_labels_plain(markers, mask))
    if name == "spiral301":  # two markers share the corridor
        assert set(got[mask].unique().tolist()) == {3, 7}


def test_families_match_plain(dev):
    hw = (700, 650)
    canvas = torch.zeros((*hw, 9), dtype=torch.float32)
    for ch, (n, seed, rmax) in enumerate([(20, 3, 60), (30, 4, 30),
                                          (60, 5, 50), (60, 6, 20),
                                          (400, 7, 9), (400, 8, 11)]):
        canvas[..., ch] = torch.from_numpy(_blob_prob(hw, n, seed,
                                                      rmax=rmax))
    canvas = canvas.to(dev)
    idx = {"Lumen-INST": [0, 2], "Gland-INST": [2, 4], "Nuclei-INST": [4, 6]}
    for tissue in ("Gland", "Lumen", "Nuclei"):
        got, _ = G.GPUPostProcInstErodedContourMap.post_process(
            canvas, idx, tissue)
        ref, _ = G.GPUPostProcInstErodedContourMap.post_process(
            canvas, idx, tissue, impl=D.PLAIN)
        np.testing.assert_array_equal(got, ref, err_msg=tissue)
        assert got.max() > 0, tissue


def _blob_plane(hw, n, seed, rmin=3, rmax=12):
    """Max of n seeded cone blobs, each drawn in its own box (cheap at WSI
    tile sizes)."""
    rng = np.random.default_rng(seed)
    prob = np.zeros(hw, np.float32)
    for _ in range(n):
        cy, cx = rng.integers(0, hw[0]), rng.integers(0, hw[1])
        rad = rng.uniform(rmin, rmax)
        r = int(np.ceil(rad))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, hw[0])
        x0, x1 = max(cx - r, 0), min(cx + r + 1, hw[1])
        yy, xx = np.mgrid[y0:y1, x0:x1]
        cone = np.clip(1 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / rad,
                       0, 1).astype(np.float32)
        prob[y0:y1, x0:x1] = np.maximum(prob[y0:y1, x0:x1], cone)
    return prob


@pytest.mark.parametrize("max_id", [300, D.HIST_CAP - 1, 40000])
def test_compact_present_ids_matches_plain(dev, max_id):
    """Below 16384 ids the sizes come from one hist16384 launch; wider id
    planes count through torch.bincount and launch nothing."""
    rng = np.random.default_rng(max_id)
    lab = np.where(rng.random((700, 900)) < 0.02,
                   rng.integers(1, max_id + 1, (700, 900)), 0)
    lab[0, 0] = max_id
    lab = torch.from_numpy(lab.astype(np.int32))
    cuda_build.reset_launch_counts()
    got, n = G.compact_present_ids(lab.to(dev))
    assert cuda_build.launch_counts["hist16384"] == int(max_id < D.HIST_CAP)
    ref, ref_n = G.compact_present_ids(lab, D.PLAIN)
    assert torch.equal(got.cpu(), ref) and int(n) == int(ref_n)
    assert int(ref_n) == len(np.unique(lab.numpy())) - 1


def test_kernels_at_the_wsi_tile_window(dev):
    """cc_label, watershed and propagate_labels on a 2560^2 nuclei-like
    plane: a WSI grid tile's nuclei window (2160-px tile, 512-padded)."""
    prob = torch.from_numpy(_blob_plane((2560, 2560), 10500, 9)).to(dev)
    fg = prob > 0.5
    assert torch.equal(connected_components(fg),
                       connected_components_plain(fg))
    markers = connected_components(prob > 0.6)
    mask = prob > 0.1
    assert torch.equal(watershed(-prob, markers, mask),
                       watershed_plain(-prob, markers, mask))
    assert torch.equal(propagate_labels(markers, mask),
                       propagate_labels_plain(markers, mask))


def test_nuclei_tile_labels_at_the_wsi_tile_window(dev):
    """The resident loop's per-tile nuclei program on a 2560^2 window of a
    clipped tile (rows and columns past the valid extent zeroed): kernel
    families equal plain families, ids compacted through hist16384."""
    from cerberus_tpu_torch.infer.resident_wsi import nuclei_tile_labels

    inner = _blob_plane((2560, 2560), 10500, 10, rmax=9)
    cnt = _blob_plane((2560, 2560), 10500, 11, rmax=9) * 0.6
    window = torch.zeros((2560, 2560, 3), dtype=torch.float16)
    window[..., 0] = torch.from_numpy(inner)
    window[..., 1] = torch.from_numpy(cnt)
    window[..., 2] = torch.from_numpy((inner * 6).round())
    window = window.to(dev)
    idx = {"Nuclei-INST": [0, 2], "Nuclei-TYPE": [2, 3]}
    code = "IP-ERODED-CONTOUR-3"
    cuda_build.reset_launch_counts()
    got = nuclei_tile_labels(window, 2160, 1340, idx, code)
    assert all(cuda_build.launch_counts[k] > 0
               for k in ("cc_label", "hist16384", "watershed"))
    ref = nuclei_tile_labels(window, 2160, 1340, idx, code, D.PLAIN)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[0].shape == (2160, 1340) and int(got[2]) > 1000


def _full_width_model(dev, seed=0):
    """A seeded full-width ResNet-34 NetDesc (six heads) with randomised
    BN statistics, on the card."""
    from cerberus_tpu_torch.config import DEFAULT_DECODER_KWARGS, ModelConfig
    from cerberus_tpu_torch.models.net_desc import NetDesc, init_weights

    cfg = ModelConfig.from_kwargs({
        "encoder_backbone_name": "resnet34",
        "decoder_kwargs": DEFAULT_DECODER_KWARGS,
        "considered_tasks": list(DEFAULT_DECODER_KWARGS)})
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(NetDesc(cfg), gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(
                    mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(
                    mod.running_var.shape, generator=gen) + 0.5)
    return model.to(dev).eval()


def test_valid_region_equals_full_towers_on_card(dev):
    """448->144, batch 2, f32 with TF32 off: valid-region heads within 1e-4
    relative of the full towers' centre crop."""
    from cerberus_tpu_torch.models.layers import center_crop
    from cerberus_tpu_torch.models.valid_decode import (
        supports_valid_region, valid_head_outputs)

    model = _full_width_model(dev)
    x = torch.rand((2, 3, 448, 448), generator=torch.Generator().manual_seed(
        1)).to(dev)
    plan = supports_valid_region(model.cfg, 448, 144)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            full = model(x)
            valid = valid_head_outputs(model, x, plan)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    for head, got in valid.items():
        ref = full[head] if head == "Patch-Class" else center_crop(
            full[head], 144, 144)
        assert got.shape == ref.shape, head
        rel = float((got - ref).abs().max()) / max(1.0,
                                                   float(ref.abs().max()))
        assert rel < 1e-4, (head, rel)


def test_dense_step_grid_on_card(dev):
    """One bf16 1168->864 step: a (2, 864, 864, 9) f16 canvas whose
    Patch-Class channel is constant on each of the 6x6 cells of 144^2 and
    holds classes in [0, 9)."""
    from cerberus_tpu_torch.data.patching import make_channel_index_map
    from cerberus_tpu_torch.infer.steps import make_infer_step

    model = _full_width_model(dev)
    imgs = torch.randint(0, 256, (2, 1168, 1168, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2)).to(dev)
    out = make_infer_step(model, model.cfg, 864)(imgs)
    assert out.shape == (2, 864, 864, 9) and out.dtype == torch.float16
    assert torch.isfinite(out).all()
    idx_dict, _ = make_channel_index_map(model.cfg.active_decoder_kwargs)
    pc = out[..., idx_dict["Patch-Class"][0]].float()
    cells = pc.reshape(2, 6, 144, 6, 144)
    assert torch.equal(cells.amax(dim=(2, 4)), cells.amin(dim=(2, 4)))
    assert 0 <= float(pc.min()) and float(pc.max()) < 9
    assert torch.equal(pc, pc.round())


# -- training (the card against the CPU; helpers in _torch_train_helpers) --

def _tf32_off():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def _tf32_restore(saved):
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_train_step_on_card_matches_cpu(dev):
    """resnet18, six heads, 96^2, batch 4, the dropout mask passed, TF32
    off: float64 equal to the CPU's within 1e-8 (loss, BN statistics) and
    1e-6 of each gradient tensor's largest magnitude; f32 loss and BN
    statistics within 1e-4, the median f32 gradient tensor's error
    against float64 within 4x the CPU's (``card_parity``)."""
    import _torch_train_helpers as H

    kwargs, state, batch, keep = H.parity_case()
    saved = _tf32_off()
    try:
        report = H.card_parity(dev, kwargs, state, batch, keep)
    finally:
        _tf32_restore(saved)
    report.pop("card_f32")
    assert report["ok"], report


def test_train_step_bf16_on_card_is_finite_and_folds_bn(dev):
    import _torch_train_helpers as H

    kwargs, state, batch, keep = H.parity_case()
    metrics, grads, after = H.step_on(dev, kwargs, state, batch, keep,
                                      compute_dtype=torch.bfloat16)
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert not torch.equal(after["backbone.bn1.running_var"],
                           state["backbone.bn1.running_var"])
    assert after["backbone.conv1.weight"].dtype == torch.float32


def test_remat_equals_plain_on_card_f32(dev):
    """``remat=True`` against plain, f32, TF32 off, deterministic cuDNN:
    the same losses and BN statistics (folded once), gradients within
    1e-4 of each tensor's largest magnitude plus 4x the card's own
    run-to-run spread (the bilinear upsampling's backward adds with
    atomics)."""
    import _torch_train_helpers as H

    kwargs, state, batch, keep = H.parity_case()
    saved = _tf32_off()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, again, remat = (
            H.step_on(dev, kwargs, state, batch, keep, remat=mode)
            for mode in (False, False, True))
    finally:
        torch.backends.cudnn.deterministic = det
        _tf32_restore(saved)
    assert remat[0] == plain[0]
    for key, value in plain[2].items():
        if "running_" in key:
            assert torch.equal(remat[2][key], value), key
    for name, ref in plain[1].items():
        spread = float((again[1][name] - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max()) + 4 * spread
        assert float((remat[1][name] - ref).abs().max()) <= tol, name
