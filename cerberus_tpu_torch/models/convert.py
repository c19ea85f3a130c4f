"""Checkpoints: the reference ``weights.tar``, the JAX parameter tree and
the JAX package's native msgpack checkpoints.

Counterpart of ``cerberus_tpu/models/convert.py`` (:28-70, :163-176,
:255-286). The port's ``NetDesc`` keeps the reference module names, so a
reference checkpoint's ``"desc"`` state_dict loads directly.
``state_dict_from_jax_params`` is the exact inverse of
``cerberus_tpu.models.convert.convert_torch_state_dict``:

  ``params[<name>]["kernel"]`` (H,W,I,O) -> ``<name>.weight`` (O,I,H,W)
  ``params[<name>]["gweight"]`` (rank 8) -> ``<name>.weight``, as it is
  ``params[<name>]["scale"]``            -> ``<name>.weight``
  ``params[<name>]["bias"]``             -> ``<name>.bias``
  ``params[<name>]["mean"/"var"]``       -> ``<name>.running_mean/var``

BN leaves also get ``num_batches_tracked = 0`` (which the forward conversion
drops), so the result loads with ``strict=True``. A reference DSF-CNN
checkpoint carries a constant ``<name>.basis_filters`` buffer per G-conv;
the JAX converter drops it, and so does every loader here (the port's
``GConv2d`` keeps its rotated basis as a non-persistent buffer).
``jax_params_from_state_dict`` is the forward conversion (a copy of the JAX
``convert_torch_state_dict``). ``load_checkpoint`` tells a torch file from a
native one by content, as the JAX loader does; native files are read by
``models/native_ckpt.py`` without flax.

Training (JAX ``:90-148``, ``:179-255``): ``convert_torchvision_backbone``,
``overlay_pretrained`` and ``resolve_pretrained_map`` on torch state dicts;
the train state ``{"params", "opt_state", "step"}`` in the JAX layout
(``save_train_state``, ``load_train_state``, ``TrainStateWriter``), with
``opt_state`` the nested dicts flax's ``to_state_dict`` makes of the optax
``multi_transform`` state:

  ``{"inner_states": {"freeze": {"inner_state": {}},
                      "train": {"inner_state": {"0": {"count", "mu", "nu"},
                                                ["1": {}  (AdamW's decay)]
                                                "1"|"2": {"count"}}}}}``

where ``mu``/``nu`` mirror the params tree and hold ``{}`` at each leaf the
optimizer does not train (BN statistics, subtype-frozen modules).
``train_state_from_jax`` / ``train_state_to_jax`` carry weights and Adam
state across (``mu``/``nu`` <-> ``exp_avg``/``exp_avg_sq``, ``count`` <->
``step``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .native_ckpt import read_native, write_native


def strip_data_parallel_prefix(state_dict: Dict) -> Dict:
    names = list(state_dict.keys())
    if names and all(n.split(".")[0] == "module" for n in names):
        return {".".join(k.split(".")[1:]): v for k, v in state_dict.items()}
    return state_dict


def drop_basis_filters(state_dict: Dict) -> Dict:
    """Without the G-convs' constant ``basis_filters`` buffers
    (``cerberus_tpu/models/convert.py:46-49``)."""
    return {k: v for k, v in state_dict.items()
            if not k.endswith(".basis_filters")}


def _desc_state_dict(ckpt) -> Dict:
    """A loaded torch checkpoint -> its ``"desc"`` state_dict with any
    DataParallel ``module.`` prefix stripped. A raw torchvision backbone
    checkpoint becomes its ``backbone.*`` part
    (``convert_torchvision_backbone``)."""
    state_dict = ckpt["desc"] if isinstance(ckpt, dict) and "desc" in ckpt \
        else ckpt
    state_dict = drop_basis_filters(strip_data_parallel_prefix(state_dict))
    if is_torchvision_backbone_state_dict(state_dict):
        return convert_torchvision_backbone(state_dict)
    return state_dict


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``weights.tar``: its ``"desc"`` state_dict with any
    DataParallel ``module.`` prefix stripped."""
    return _desc_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=False))


def is_torchvision_backbone_state_dict(state_dict: Dict) -> bool:
    """A raw torchvision ImageNet checkpoint (``conv1.weight``,
    ``layer1...``, ``features...``) rather than a NetDesc one, whose
    encoder keys live under ``backbone.`` (the JAX function of this
    name)."""
    keys = [k[len("module."):] if k.startswith("module.") else k
            for k in state_dict]
    return (bool(keys)
            and not any(k.startswith("backbone.") for k in keys)
            and any(k.startswith(("conv1.", "features.", "layer1."))
                    for k in keys))


_TORCHVISION_HEAD_PREFIXES = ("fc.", "classifier.")


def convert_torchvision_backbone(state_dict: Dict) -> Dict:
    """A torchvision ImageNet state_dict -> the ``backbone.*`` part of a
    NetDesc state_dict (JAX ``convert_torchvision_backbone``): the
    classifier (``fc.``/``classifier.``) dropped, the rest prefixed. The
    result is partial: ``overlay_pretrained`` puts it on a fresh init."""
    state_dict = strip_data_parallel_prefix(state_dict)
    return {"backbone." + k: v for k, v in state_dict.items()
            if not k.startswith(_TORCHVISION_HEAD_PREFIXES)}


def overlay_pretrained(init_state: Dict, pretrained: Dict) -> Dict:
    """A (possibly partial) pretrained state_dict over a fresh init (JAX
    ``overlay_pretrained``, the reference's
    ``backbone_imagenet_pretrained``): entries the model lacks are skipped
    (a full-task checkpoint may feed a reduced-task config); a shape that
    differs from the model's raises ``ValueError``."""
    out = dict(init_state)
    for key, value in pretrained.items():
        if key not in init_state:
            continue
        if tuple(value.shape) != tuple(init_state[key].shape):
            raise ValueError("pretrained %s shape %s != model shape %s"
                             % (key, tuple(value.shape),
                                tuple(init_state[key].shape)))
        out[key] = value
    return out


def resolve_pretrained_map(map_path: str, backbone: str, fold,
                           tag: str = "imagenet_mtl") -> str:
    """A checkpoint path from a ``pretrained.yml``-style map (reference
    ``models/pretrained.yml``: backbone -> foldN -> tag -> path); relative
    paths resolve against the map's directory."""
    import yaml

    with open(map_path) as handle:
        table = yaml.safe_load(handle)
    try:
        path = table[backbone]["fold%d" % int(fold)][tag]
    except (KeyError, TypeError) as exc:
        raise ValueError("%s: no entry for backbone=%r fold%s/%r"
                         % (map_path, backbone, fold, tag)) from exc
    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(os.path.abspath(map_path)), path)
    return path


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint of either kind -> torch state_dict, told apart by
    content as ``cerberus_tpu/models/convert.py:255-286`` does:

      1. a ``PK`` zip is read as torch;
      2. a ``.tar``, ``.pt`` or ``.pth`` file that ``torch.load`` parses is
         read as torch (an error in its conversion surfaces);
      3. anything else is native msgpack: its ``params`` go through
         ``state_dict_from_jax_params``.
    """
    with open(path, "rb") as handle:
        magic = handle.read(2)
    if magic == b"PK":
        return load_torch_checkpoint(path)
    if path.endswith((".tar", ".pt", ".pth")):
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
        except Exception:  # noqa: BLE001 — not a torch file: try native
            ckpt = None
        if ckpt is not None:
            return _desc_state_dict(ckpt)
    return state_dict_from_jax_params(load_native_params(path))


def load_native_params(path: str) -> Dict:
    """A native checkpoint's ``params`` tree (the JAX
    ``load_native_checkpoint``)."""
    tree = read_native(path)
    if not isinstance(tree, dict) or not isinstance(tree.get("params"),
                                                    dict):
        raise ValueError("%s: not a native checkpoint (no params tree)"
                         % path)
    return tree["params"]


def save_native_checkpoint(path: str, params: Dict, step: int = 0) -> None:
    """The JAX ``save_checkpoint``: ``{"params", "step"}`` as flax writes
    it, through a temporary file and a rename."""
    write_native(path, {"params": {k: dict(v) for k, v in params.items()},
                        "step": np.int64(step)})


_ATTR = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_JAX_ATTR = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def _torch_entry(name: str, attr: str, value) -> tuple:
    """One JAX leaf entry -> (torch attribute, float32 numpy array)."""
    value = np.asarray(value, dtype=np.float32)
    if attr == "kernel":
        if value.ndim == 4:    # HWIO -> OIHW
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:    # linear (I,O) -> (O,I)
            return "weight", value.T
        raise ValueError("unrecognized kernel rank for %s" % name)
    if attr == "gweight":  # steerable G-conv coefficients, kept as they are
        return "weight", value
    if attr in _ATTR:
        return _ATTR[attr], value
    raise ValueError("unrecognized parameter %s.%s" % (name, attr))


def _jax_entry(key: str, value) -> tuple:
    """One torch state_dict entry -> (module name, JAX attribute, numpy
    array); ``num_batches_tracked`` gives attribute None."""
    value = np.asarray(value.detach().cpu().numpy()
                       if hasattr(value, "detach") else value)
    name, attr = key.rsplit(".", 1)
    if attr == "num_batches_tracked":
        return name, None, value
    if attr == "weight":
        if value.ndim == 4:    # OIHW -> HWIO
            return name, "kernel", np.transpose(value, (2, 3, 1, 0)).copy()
        if value.ndim == 1:    # norm scale
            return name, "scale", value.astype(np.float32)
        if value.ndim == 2:    # linear (O,I) -> (I,O)
            return name, "kernel", value.T.copy()
        if value.ndim == 8:    # steerable G-conv coefficients, as they are
            return name, "gweight", value.astype(np.float32)
        raise ValueError("unrecognized weight rank for %s" % key)
    if attr in _JAX_ATTR:
        return name, _JAX_ATTR[attr], value.astype(np.float32)
    raise ValueError("unrecognized checkpoint entry: %s" % key)


def state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX flat tree ``{name: {attr: array}}`` (numpy or array-like values)
    -> torch state_dict of float32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        for attr, value in leaf.items():
            key, value = _torch_entry(name, attr, value)
            out["%s.%s" % (name, key)] = torch.tensor(value)
        if "mean" in leaf:
            out["%s.num_batches_tracked" % name] = torch.tensor(0)
    return out


def jax_params_from_state_dict(state_dict: Dict) -> Dict[str, Dict]:
    """torch state_dict -> the JAX flat tree of numpy arrays (the JAX
    ``convert_torch_state_dict``; ``num_batches_tracked`` is dropped)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in drop_basis_filters(
            strip_data_parallel_prefix(state_dict)).items():
        name, attr, value = _jax_entry(key, value)
        if attr is not None:
            params.setdefault(name, {})[attr] = value
    return params


# -- train state -------------------------------------------------------------

def train_state_from_jax(params: Dict, opt_state: Optional[Dict],
                         param_names: List[str]):
    """A JAX-layout train state -> (NetDesc state_dict, optimizer
    state_dict). ``param_names`` are the optimizer's parameters in order
    (``TrainStep.param_names``). The optimizer state_dict's
    ``param_groups`` hold only the parameter indices: the caller merges its
    own hyperparameters in. ``opt_state`` None (or empty) gives no
    moments."""
    state_dict = state_dict_from_jax_params(params)
    state = {}
    if opt_state:
        moments = opt_state["inner_states"]["train"]["inner_state"]["0"]
        count = torch.tensor(float(np.asarray(moments["count"])))
        for idx, key in enumerate(param_names):
            name, attr = key.rsplit(".", 1)
            attr = _jax_entry(key, state_dict[key])[1]
            _, exp_avg = _torch_entry(name, attr, moments["mu"][name][attr])
            _, exp_avg_sq = _torch_entry(name, attr,
                                         moments["nu"][name][attr])
            state[idx] = {"step": count.clone(),
                          "exp_avg": torch.tensor(exp_avg),
                          "exp_avg_sq": torch.tensor(exp_avg_sq)}
    return state_dict, {"state": state, "param_groups": [
        {"params": list(range(len(param_names)))}]}


def train_state_to_jax(state_dict: Dict, optimizer_state: Dict,
                       param_names: List[str], weight_decay: bool,
                       step: int):
    """The inverse of ``train_state_from_jax``: (params, opt_state, step)
    as numpy trees in the JAX layout; ``weight_decay`` selects AdamW's
    state (an empty entry for the decay between Adam and the schedule).
    Parameters the optimizer has no state for yet carry zero moments and
    count 0."""
    params = jax_params_from_state_dict(state_dict)
    mu = {name: {attr: {} for attr in leaf} for name, leaf in params.items()}
    nu = {name: {attr: {} for attr in leaf} for name, leaf in params.items()}
    state = optimizer_state["state"]
    count = 0
    for idx, key in enumerate(param_names):
        name, attr, value = _jax_entry(key, state_dict[key])
        entry = state.get(idx)
        if entry:
            count = int(entry["step"])
            mu[name][attr] = _jax_entry(key, entry["exp_avg"])[2]
            nu[name][attr] = _jax_entry(key, entry["exp_avg_sq"])[2]
        else:
            mu[name][attr] = np.zeros_like(value, dtype=np.float32)
            nu[name][attr] = np.zeros_like(value, dtype=np.float32)
    count = np.asarray(count, np.int32)
    inner = {"0": {"count": count, "mu": mu, "nu": nu}}
    if weight_decay:
        inner["1"] = {}
    inner[str(len(inner))] = {"count": count.copy()}
    opt_state = {"inner_states": {"freeze": {"inner_state": {}},
                                  "train": {"inner_state": inner}}}
    return params, opt_state, int(step)


def save_train_state(path: str, params: Dict, opt_state=None,
                     step: int = 0) -> None:
    """The JAX ``save_train_state``: ``{"params", "opt_state", "step"}``,
    loadable as a params-only checkpoint too."""
    write_native(path, {"params": {k: dict(v) for k, v in params.items()},
                        "opt_state": opt_state or {},
                        "step": np.int64(step)})


def load_train_state(path: str):
    """(params, opt_state or None, step) of a train-state file (JAX
    ``load_train_state`` without a template: ``opt_state`` stays the
    nested dicts)."""
    tree = read_native(path)
    if not isinstance(tree, dict) or not isinstance(tree.get("params"),
                                                    dict):
        raise ValueError("%s: not a native checkpoint (no params tree)"
                         % path)
    return tree["params"], tree.get("opt_state") or None, \
        int(tree.get("step", 0))


class TrainStateWriter:
    """Train-state writes on one background thread, in order (JAX
    ``save_train_state_async`` / ``flush_pending_saves``): the caller pays
    the host snapshot it passes in; msgpack encoding and the disk write
    overlap the following steps. ``flush`` waits for every write, then
    re-raises the first failure."""

    def __init__(self):
        self._pool = None
        self._futures = []

    def submit(self, path: str, params: Dict, opt_state, step: int):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="ckpt_writer")
        future = self._pool.submit(save_train_state, path, params, opt_state,
                                   step)
        self._futures.append(future)
        return future

    def flush(self) -> None:
        pending, self._futures = self._futures, []
        first = None
        for future in pending:
            try:
                future.result()
            except Exception as exc:  # noqa: BLE001 — re-raised below
                if first is None:
                    first = exc
        if first is not None:
            raise first
