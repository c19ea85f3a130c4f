"""Patch-classifier evaluation on the CPU
(``cerberus_tpu_torch/infer/patch.py``,
``python -m cerberus_tpu_torch.run_eval_patch``): the numpy metrics against
sklearn's and the JAX ``evaluate_classification``, the ``.dat`` loader on
pickle and joblib payloads, and the CLI against JAX ``process_file_list``
on shared weights."""
import os
import pickle
import subprocess
import sys

import joblib
import numpy as np
import pytest
import torch
from sklearn import metrics

import conftest  # noqa: F401  (CPU pinning)

import jax.numpy as jnp

from cerberus_tpu.config import DEFAULT_TARGET_CODE
from cerberus_tpu.infer import patch as jax_patch
from cerberus_tpu.models.convert import save_checkpoint
from cerberus_tpu_torch import run_eval_patch
from cerberus_tpu_torch.infer import patch as port_patch
from test_torch_tile_cache import MODEL_KWARGS, model_params, write_model_dir

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probs(seed, n=60, k=9, ties=False, absent=(3, 7)):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(k), n).astype(np.float32)
    if ties:  # coarse scores: many tied thresholds per class
        probs = np.round(probs * 4) / 4
    labels = rng.choice([c for c in range(k) if c not in absent], n)
    return labels, probs


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_evaluate_classification_equals_sklearn_and_jax(seed, ties, capsys):
    labels, probs = _probs(seed, ties=ties)
    names = {i + 1: str(i + 1) for i in range(9)}
    got = port_patch.evaluate_classification(labels, probs, names)
    port_out = capsys.readouterr().out
    ref = jax_patch.evaluate_classification(labels, probs, names)
    assert capsys.readouterr().out == port_out
    assert set(got) == set(ref)
    for key in ("acc_all", "avg_acc", "avg_ap", "avg_f1"):
        assert got[key] == ref[key], key
    np.testing.assert_array_equal(got["conf_mat"], ref["conf_mat"])
    for k in range(9):
        y = (labels == k).astype(int)
        if y.sum():
            assert port_patch.average_precision(y, probs[:, k]) == \
                metrics.average_precision_score(y, probs[:, k])
    pred = probs.argmax(-1)
    np.testing.assert_array_equal(
        port_patch.f1_per_class(labels, pred, 9),
        metrics.f1_score(labels, pred, average=None, labels=np.arange(9),
                         zero_division=0))


def _write_dat(path, img, ann, kind):
    payload = {"img": img, "ann": ann}
    if kind == "pickle":
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    else:
        joblib.dump(payload, path, compress=3 if kind == "joblib_z" else 0)


def test_loader_reads_pickle_and_joblib(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (3, 160, 160, 3)).astype(np.uint8)
    paths = []
    for i, kind in enumerate(("pickle", "joblib", "joblib_z")):
        paths.append(str(tmp_path / ("p%d.dat" % i)))
        _write_dat(paths[-1], imgs[i], i + 2, kind)
    got, labels = port_patch.load_patch_dataset(paths, 144)
    np.testing.assert_array_equal(got, imgs[:, 8:152, 8:152])
    np.testing.assert_array_equal(labels, [2, 3, 4])
    # without joblib the pickle still loads; a joblib payload names joblib
    monkeypatch.setitem(sys.modules, "joblib", None)
    port_patch.load_patch_dataset(paths[:1], 144)
    with pytest.raises(ImportError, match="joblib"):
        port_patch.load_patch_dataset(paths[1:2], 144)


@pytest.fixture(scope="module")
def patch_set(tmp_path_factory):
    """24 joblib-written 160^2 patches in 3 classes (as
    ``tests/test_longtail.py`` writes them) and the test model's
    directory."""
    root = tmp_path_factory.mktemp("patch_eval")
    input_dir = root / "patches"
    os.makedirs(input_dir)
    rng = np.random.default_rng(0)
    for i in range(24):
        _write_dat(str(input_dir / ("p%02d.dat" % i)),
                   rng.integers(0, 255, (160, 160, 3)).astype(np.uint8),
                   i % 3, "joblib")
    params = model_params()
    model_dir = write_model_dir(str(root / "model"), params)
    return input_dir, model_dir, params


def test_cli_metrics_and_probabilities_equal_jax(patch_set, monkeypatch):
    """On shared weights: the CLI's metrics equal JAX
    ``process_file_list``'s, and the probabilities both hand to
    ``evaluate_classification`` agree (f32, 2e-4 relative; the batches of
    5 leave a zero-padded tail)."""
    input_dir, model_dir, params = patch_set
    probs = {}

    def capture(side, fn):
        def wrapped(true_list, prob_list, class_names):
            probs[side] = np.array(prob_list)
            return fn(true_list, prob_list, class_names)
        return wrapped

    monkeypatch.setattr(port_patch, "evaluate_classification",
                        capture("port", port_patch.evaluate_classification))
    monkeypatch.setattr(jax_patch, "evaluate_classification",
                        capture("jax", jax_patch.evaluate_classification))
    got = run_eval_patch.main(["--model=%s" % model_dir,
                               "--input_dir=%s" % input_dir,
                               "--batch_size=5"], device="cpu")
    ref = jax_patch.InferManager(
        checkpoint_path=os.path.join(model_dir, "weights.tar"),
        decoder_dict=dict(DEFAULT_TARGET_CODE), model_args=MODEL_KWARGS,
        compute_dtype=jnp.float32).process_file_list({
            "input_dir": str(input_dir), "batch_size": 5,
            "patch_input_shape": 144})
    assert probs["port"].shape == probs["jax"].shape == (24, 9)
    np.testing.assert_allclose(probs["port"], probs["jax"], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got["conf_mat"], ref["conf_mat"])
    for key in ("acc_all", "avg_acc", "avg_ap", "avg_f1"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6,
                                   err_msg=key)


def test_cli_on_a_jax_written_checkpoint_in_a_subprocess(patch_set,
                                                         tmp_path):
    """``CERBERUS_DEFAULT_DEVICE=cpu python -m
    cerberus_tpu_torch.run_eval_patch`` on a model directory whose
    ``weights.tar`` is the JAX package's native msgpack file."""
    input_dir, model_dir, params = patch_set
    native_dir = tmp_path / "native"
    os.makedirs(native_dir)
    save_checkpoint(str(native_dir / "weights.tar"), params)
    with open(native_dir / "settings.yml", "w") as f:
        f.write(open(os.path.join(model_dir, "settings.yml")).read())
    env = dict(os.environ, PYTHONPATH=ROOT, CERBERUS_DEFAULT_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "cerberus_tpu_torch.run_eval_patch",
         "--model=%s" % native_dir, "--input_dir=%s" % input_dir,
         "--batch_size=8"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = run_eval_patch.main(["--model=%s" % model_dir,
                               "--input_dir=%s" % input_dir,
                               "--batch_size=8"], device="cpu")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("ALL-accu")]
    assert line and float(line[0].split()[1]) == ref["acc_all"]
