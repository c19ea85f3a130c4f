"""Base inference manager: checkpoint load + step binding.

Counterpart of ``cerberus_tpu/infer/manager.py:43-103`` (reference
``infer/base.py:9-54``): constructor kwargs become attributes, the model is
built from ``model_args``, the ``weights.tar`` checkpoint's ``desc``
state_dict is loaded (DataParallel ``module.`` prefixes stripped), the
weights are placed on the device once, and one step is bound per output
shape (valid-region decoding unless ``CERBERUS_VALID_REGION=0`` when the
step is bound). Without a checkpoint the weights are random, from a seeded
``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig
from ..models.convert import load_torch_checkpoint
from ..models.net_desc import NetDesc, init_weights
from .steps import make_infer_step


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); raises when CUDA is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


class InferManager:
    def __init__(self, checkpoint_path: Optional[str] = None,
                 decoder_dict: Optional[dict] = None,
                 model_args: Optional[dict] = None,
                 device=None, **kwargs):
        """On the card the forward computes in bf16 and the canvas is f16
        (the JAX package's numerics policy); on the CPU both are f32."""
        self.checkpoint_path = checkpoint_path
        self.decoder_dict = decoder_dict or {}
        self.model_args = model_args or {}
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.compute_dtype = torch.bfloat16 if on_card else torch.float32
        self.out_dtype = torch.float16 if on_card else torch.float32
        for variable, value in kwargs.items():
            setattr(self, variable, value)
        self.cfg = ModelConfig.from_kwargs(self.model_args)
        model = NetDesc(self.cfg)
        if self.checkpoint_path is None:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(load_torch_checkpoint(self.checkpoint_path),
                                  strict=True)
        self.model = model.to(self.device).eval()
        self._step_cache: Dict[int, Callable] = {}

    def run_step(self, batch: torch.Tensor, output_shape: int) -> torch.Tensor:
        """uint8 NHWC batch on the device -> (N, out, out, C) tensor."""
        if output_shape not in self._step_cache:
            self._step_cache[output_shape] = make_infer_step(
                self.model, self.cfg, output_shape, self.compute_dtype,
                self.out_dtype)
        return self._step_cache[output_shape](batch)
