"""The ``--postproc_backend=cpu`` families of the port against the JAX
package's: ``ops/cc_cpu`` and both scipy/cv2 oracle families
(``ops/postproc``) byte-equal on the same raw maps, for Gland, Lumen and
Nuclei, both target codes, ``ds_factor`` 1 and 0.5. Then the port's
``gpu`` families (their plain versions, on CPU tensors) against its
``cpu`` families within the JAX package's own cpu-against-tpu bounds
(``tests/test_lax_postproc.py``): gland label maps isomorphic with equal
types, nuclei counts equal and < 1 % of pixels in disagreement."""
import numpy as np
import pytest
import torch

from cerberus_tpu.ops import cc_cpu as jax_cc
from cerberus_tpu.ops import postproc as jax_pp
from cerberus_tpu_torch.ops import cc_cpu as port_cc
from cerberus_tpu_torch.ops import postproc as port_pp
from cerberus_tpu_torch.ops.gpu_postproc import GPU_POSTPROC_FUNC_DICT

from tests.test_lax_postproc import _contour_raw, _label_isomorphic

CODES = ("IP-ERODED-3", "IP-ERODED-11", "IP-ERODED-CONTOUR-3",
         "IP-ERODED-CONTOUR-11")
IDX = {"Gland-INST": [0, 2], "Lumen-INST": [2, 4], "Nuclei-INST": [4, 6],
       "Gland-TYPE": [6, 7], "Nuclei-TYPE": [7, 8]}


def _blobs(hw, seed, n, rmin, rmax, value=0.9):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    plane = np.zeros((hw, hw), np.float32)
    for _ in range(n):
        cy, cx = rng.integers(0, hw, 2)
        r = rng.integers(rmin, rmax)
        plane[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = value
    return plane


def _raw_map(hw=192, seed=0):
    """Seeded (hw, hw, 8) map: per task an inner probability with blobs and
    noise and a contour channel along the blobs' rims; type ids."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((hw, hw, 8), np.float32)
    for task, (n, rmin, rmax) in {"Gland": (5, 20, 34), "Lumen": (8, 7, 14),
                                  "Nuclei": (40, 3, 7)}.items():
        s = IDX[f"{task}-INST"][0]
        inner = _blobs(hw, seed + s, n, rmin, rmax)
        inner = np.clip(inner + rng.normal(0, 0.15, inner.shape), 0, 1)
        rim = _blobs(hw, seed + s, n, rmin + 2, rmax + 2) - _blobs(
            hw, seed + s, n, rmin, rmax)
        raw[..., s] = inner
        raw[..., s + 1] = np.clip(rim + rng.normal(0, 0.1, rim.shape), 0, 1)
    raw[..., 6] = rng.integers(0, 3, (hw, hw))
    raw[..., 7] = rng.integers(0, 7, (hw, hw))
    return raw


def test_cc_cpu_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random((96, 96)) > 0.55
    np.testing.assert_array_equal(port_cc.label(mask)[0],
                                  jax_cc.label(mask)[0])
    np.testing.assert_array_equal(port_cc.binary_fill_holes(mask),
                                  jax_cc.binary_fill_holes(mask))
    lab, _ = jax_cc.label(mask)
    for ar in (mask, lab):
        for min_size in (0, 3, 8):
            got = port_cc.remove_small_objects(ar, min_size)
            ref = jax_cc.remove_small_objects(ar, min_size)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    image = -rng.random((96, 96)).astype(np.float32)
    markers = port_cc.label(rng.random((96, 96)) > 0.97)[0]
    fg = rng.random((96, 96)) > 0.2
    for m in (fg, None):
        np.testing.assert_array_equal(port_cc.watershed(image, markers, m),
                                      jax_cc.watershed(image, markers, m))


@pytest.mark.parametrize("ds_factor", [1.0, 0.5])
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("task", ["Gland", "Lumen", "Nuclei"])
def test_oracle_families_byte_equal_to_jax(task, code, ds_factor):
    raw = _raw_map(seed=1)
    idx = dict(IDX)
    if "CONTOUR" not in code:  # the eroded-map heads have one INST channel
        idx = {k: ([v[0], v[0] + 1] if k.endswith("INST") else v)
               for k, v in IDX.items()}
    got_inst, got_type = port_pp.POSTPROC_FUNC_DICT[code].post_process(
        raw, idx, task, ds_factor)
    ref_inst, ref_type = jax_pp.POSTPROC_FUNC_DICT[code].post_process(
        raw, idx, task, ds_factor)
    assert got_inst.dtype == ref_inst.dtype
    np.testing.assert_array_equal(got_inst, ref_inst)
    assert ref_inst.max() > 0, "no instances: the case is vacuous"
    if ref_type is None:
        assert got_type is None
    else:
        np.testing.assert_array_equal(got_type, ref_type)


def test_instance_info_byte_equal_to_jax():
    raw = _raw_map(seed=2)
    inst, types = port_pp.PostProcInstErodedContourMap.post_process(
        raw, IDX, "Nuclei")
    for ds in (1.0, 0.5):
        got = port_pp.get_inst_info_dict(inst, types, ds)
        ref = jax_pp.get_inst_info_dict(inst, types, ds)
        assert list(got) == list(ref) and len(got) > 0
        for k in ref:
            for field, value in ref[k].items():
                np.testing.assert_array_equal(got[k][field], value)


def test_gpu_gland_family_isomorphic_to_cpu_family():
    # blobs kept > 2*ksize from the borders: the cpu family keeps the
    # reference's border clamp, the device family grows uniformly
    raw = np.zeros((192, 192, 4), np.float32)
    raw[..., 0:2] = _contour_raw(192, [(30, 80, 30, 80),
                                       (100, 150, 100, 150)])
    idx = {"Gland-INST": [0, 2], "Gland-TYPE": [3, 4]}
    cpu_inst, cpu_type = port_pp.PostProcInstErodedContourMap.post_process(
        raw, idx, "Gland")
    gpu_inst, gpu_type = GPU_POSTPROC_FUNC_DICT[
        "IP-ERODED-CONTOUR-11"].post_process(torch.from_numpy(raw), idx,
                                             "Gland")
    assert cpu_inst.max() == 2
    assert _label_isomorphic(cpu_inst, gpu_inst)
    np.testing.assert_array_equal(np.asarray(cpu_type), gpu_type)


@pytest.mark.parametrize("seed", [0, 1])
def test_gpu_nuclei_family_close_to_cpu_family(seed):
    raw = np.zeros((96, 96, 3), np.float32)
    blobs = [(10, 26, 10, 26), (10, 26, 27, 43), (40, 60, 40, 60),
             (70, 90, 20, 40)]
    raw[..., 0:2] = _contour_raw(96, blobs)
    if seed:
        raw = np.concatenate([_raw_map(96, seed)[..., 4:6],
                              raw[..., 2:]], -1)
    idx = {"Nuclei-INST": [0, 2]}
    cpu_inst, _ = port_pp.PostProcInstErodedContourMap.post_process(
        raw, idx, "Nuclei")
    gpu_inst, _ = GPU_POSTPROC_FUNC_DICT["IP-ERODED-CONTOUR-3"].post_process(
        torch.from_numpy(raw), idx, "Nuclei")
    assert cpu_inst.max() > 0
    assert len(np.unique(cpu_inst)) == len(np.unique(gpu_inst))
    disagree = ((cpu_inst > 0) != (gpu_inst > 0)).mean()
    assert disagree < 0.01
