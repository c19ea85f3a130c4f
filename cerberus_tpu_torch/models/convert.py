"""Checkpoints: the reference ``weights.tar`` and the JAX parameter tree.

Counterpart of ``cerberus_tpu/models/convert.py:28-70,255-286``. The port's
``NetDesc`` keeps the reference module names, so a reference checkpoint's
``"desc"`` state_dict loads directly. ``state_dict_from_jax_params`` is the
exact inverse of ``cerberus_tpu.models.convert.convert_torch_state_dict``:

  ``params[<name>]["kernel"]`` (H,W,I,O) -> ``<name>.weight`` (O,I,H,W)
  ``params[<name>]["scale"]``            -> ``<name>.weight``
  ``params[<name>]["bias"]``             -> ``<name>.bias``
  ``params[<name>]["mean"/"var"]``       -> ``<name>.running_mean/var``

BN leaves also get ``num_batches_tracked = 0`` (which the forward conversion
drops), so the result loads with ``strict=True``. Native msgpack
checkpoints need flax and are not read here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def strip_data_parallel_prefix(state_dict: Dict) -> Dict:
    names = list(state_dict.keys())
    if names and all(n.split(".")[0] == "module" for n in names):
        return {".".join(k.split(".")[1:]): v for k, v in state_dict.items()}
    return state_dict


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``weights.tar``: its ``"desc"`` state_dict with any
    DataParallel ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt["desc"] if isinstance(ckpt, dict) and "desc" in ckpt \
        else ckpt
    return strip_data_parallel_prefix(state_dict)


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
