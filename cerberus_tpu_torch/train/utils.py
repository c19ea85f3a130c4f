"""Training-run utilities (counterpart of ``cerberus_tpu/train/utils.py``;
reference ``run_utils/utils.py``): head-logit taming for random-init
models, seeding, the log directory guard and the parameter table.

The JAX functions take the flat parameter tree; these take a NetDesc
state_dict (or module), whose entries group by module name into the same
rows: BN statistics count as parameters there too, and
``num_batches_tracked`` is left out.
"""
from __future__ import annotations

import os
import random
import shutil
from typing import Dict

import numpy as np
import torch


def tame_head_logits(state_dict: Dict[str, torch.Tensor],
                     factor: float = 0.05, inst_only: bool = False,
                     zero_bias: bool = False) -> Dict[str, torch.Tensor]:
    """Scale the final head convs so random-init logits are O(1) (JAX
    ``tame_head_logits``): the ``output_head.*.x.1.conv`` weights and
    ``decoder_head.Patch-Class.conv2`` (only the ``*.INST`` heads with
    ``inst_only``; ``zero_bias`` zeroes their biases). Returns a new
    state_dict; raises ``ValueError`` when no head conv matches."""
    out = dict(state_dict)
    hits = 0
    for key, value in state_dict.items():
        name, attr = key.rsplit(".", 1)
        if inst_only:
            hit = name.endswith(".INST.x.1.conv") and \
                name.startswith("output_head.")
        else:
            hit = (name.endswith(".x.1.conv")
                   and name.startswith("output_head.")) or \
                name == "decoder_head.Patch-Class.conv2"
        if not hit:
            continue
        if attr == "weight":
            hits += 1
            out[key] = value * factor
        elif attr == "bias" and zero_bias:
            out[key] = torch.zeros_like(value)
    if not hits:
        raise ValueError("tame_head_logits matched no head conv weights — "
                         "did the output_head naming change?")
    return out


def check_manual_seed(seed: int) -> torch.Generator:
    """Seed Python and numpy and return a ``torch.Generator`` seeded with
    ``seed`` (the global torch RNG is not used)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def check_log_dir(log_dir: str, interactive: bool = True) -> None:
    """Refuse to clobber an existing log dir without confirmation."""
    if not os.path.isdir(log_dir):
        os.makedirs(log_dir)
        return
    if interactive:
        answer = input(f"Log dir '{log_dir}' exists. Overwrite? [y/N] ")
        if answer.strip().lower() != "y":
            raise SystemExit("aborted: log dir exists")
    shutil.rmtree(log_dir)
    os.makedirs(log_dir)


def _layer_sizes(state_dict) -> Dict[str, int]:
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    sizes: Dict[str, int] = {}
    for key, value in state_dict.items():
        name, attr = key.rsplit(".", 1)
        if attr != "num_batches_tracked":
            sizes[name] = sizes.get(name, 0) + int(value.numel())
    return sizes


def count_parameters(state_dict) -> int:
    """Entries of a state_dict (or module), BN statistics included."""
    return sum(_layer_sizes(state_dict).values())


def get_model_summary(state_dict) -> str:
    """Layer table: name, parameter count (JAX ``get_model_summary``)."""
    sizes = _layer_sizes(state_dict)
    lines = ["{:<60s} {:>12s}".format("layer", "#params")]
    for name in sorted(sizes):
        lines.append("{:<60s} {:>12,d}".format(name, sizes[name]))
    lines.append("{:<60s} {:>12,d}".format("TOTAL", sum(sizes.values())))
    return "\n".join(lines)
