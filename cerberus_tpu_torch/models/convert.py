"""Checkpoints: the reference ``weights.tar``, the JAX parameter tree and
the JAX package's native msgpack checkpoints.

Counterpart of ``cerberus_tpu/models/convert.py`` (:28-70, :163-176,
:255-286). The port's ``NetDesc`` keeps the reference module names, so a
reference checkpoint's ``"desc"`` state_dict loads directly.
``state_dict_from_jax_params`` is the exact inverse of
``cerberus_tpu.models.convert.convert_torch_state_dict``:

  ``params[<name>]["kernel"]`` (H,W,I,O) -> ``<name>.weight`` (O,I,H,W)
  ``params[<name>]["scale"]``            -> ``<name>.weight``
  ``params[<name>]["bias"]``             -> ``<name>.bias``
  ``params[<name>]["mean"/"var"]``       -> ``<name>.running_mean/var``

BN leaves also get ``num_batches_tracked = 0`` (which the forward conversion
drops), so the result loads with ``strict=True``.
``jax_params_from_state_dict`` is the forward conversion (a copy of the JAX
``convert_torch_state_dict``). ``load_checkpoint`` tells a torch file from a
native one by content, as the JAX loader does; native files are read by
``models/native_ckpt.py`` without flax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .native_ckpt import read_native, write_native


def strip_data_parallel_prefix(state_dict: Dict) -> Dict:
    names = list(state_dict.keys())
    if names and all(n.split(".")[0] == "module" for n in names):
        return {".".join(k.split(".")[1:]): v for k, v in state_dict.items()}
    return state_dict


def _desc_state_dict(ckpt) -> Dict:
    """A loaded torch checkpoint -> its ``"desc"`` state_dict with any
    DataParallel ``module.`` prefix stripped. A raw torchvision backbone
    checkpoint raises ``NotImplementedError``."""
    state_dict = ckpt["desc"] if isinstance(ckpt, dict) and "desc" in ckpt \
        else ckpt
    state_dict = strip_data_parallel_prefix(state_dict)
    if is_torchvision_backbone_state_dict(state_dict):
        raise NotImplementedError(
            "a raw torchvision backbone checkpoint is a partial tree for "
            "training; the pretrained-weight helpers are ROADMAP queue 1 "
            "item 5 (training)")
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


def state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX flat tree ``{name: {attr: array}}`` (numpy or array-like values)
    -> torch state_dict of float32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        for attr, value in leaf.items():
            value = np.asarray(value, dtype=np.float32)
            if attr == "kernel":
                if value.ndim == 4:    # HWIO -> OIHW
                    value = np.transpose(value, (3, 2, 0, 1))
                elif value.ndim == 2:  # linear (I,O) -> (O,I)
                    value = value.T
                else:
                    raise ValueError("unrecognized kernel rank for %s" % name)
                key = "weight"
            elif attr in _ATTR:
                key = _ATTR[attr]
            else:
                raise ValueError("unrecognized parameter %s.%s" % (name, attr))
            out["%s.%s" % (name, key)] = torch.tensor(value)
        if "mean" in leaf:
            out["%s.num_batches_tracked" % name] = torch.tensor(0)
    return out


def jax_params_from_state_dict(state_dict: Dict) -> Dict[str, Dict]:
    """torch state_dict -> the JAX flat tree of numpy arrays (the JAX
    ``convert_torch_state_dict``; ``num_batches_tracked`` is dropped)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in strip_data_parallel_prefix(state_dict).items():
        value = np.asarray(value.detach().cpu().numpy()
                           if hasattr(value, "detach") else value)
        name, attr = key.rsplit(".", 1)
        if attr == "num_batches_tracked":
            continue
        leaf = params.setdefault(name, {})
        if attr == "weight":
            if value.ndim == 4:    # OIHW -> HWIO
                leaf["kernel"] = np.transpose(value, (2, 3, 1, 0)).copy()
            elif value.ndim == 1:  # norm scale
                leaf["scale"] = value.astype(np.float32)
            elif value.ndim == 2:  # linear (O,I) -> (I,O)
                leaf["kernel"] = value.T.copy()
            else:
                raise ValueError("unrecognized weight rank for %s" % key)
        elif attr in ("bias", "running_mean", "running_var"):
            leaf[{"bias": "bias", "running_mean": "mean",
                  "running_var": "var"}[attr]] = value.astype(np.float32)
        else:
            raise ValueError("unrecognized checkpoint entry: %s" % key)
    return params
