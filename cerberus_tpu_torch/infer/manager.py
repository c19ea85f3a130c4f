"""Base inference manager: checkpoint load + step binding.

Counterpart of ``cerberus_tpu/infer/manager.py:43-103`` (reference
``infer/base.py:9-54``): constructor kwargs become attributes, the model is
built from ``model_args``, the ``weights.tar`` checkpoint's ``desc``
state_dict is loaded (DataParallel ``module.`` prefixes stripped), the
weights are placed on the device once, and one step is bound per output
shape (valid-region decoding unless ``CERBERUS_VALID_REGION=0`` when the
step is bound). Without a checkpoint the weights are random, from a seeded
``torch.Generator``. As the JAX manager does, it also takes ``params=``, a
JAX-layout tree of numpy arrays, in place of a checkpoint; the checkpoint
may be a torch file or a native msgpack one (``models/convert.load_checkpoint``).

``mesh`` (``cerberus_tpu/infer/manager.py:49-67, 93-98``): a
single-controller ``parallel.mesh.Mesh`` shards every batch of
``run_step`` over its devices (``make_sharded_infer_step``), the
DataParallel of the reference (the CLIs build it from a ``--gpu``
list). Batches are gathered, and canvases stitched, on
``mesh.devices[0]``, which is the manager's ``device``.

``fuse_decoders=True`` (a constructor keyword, default False): the step of
the manager's own device runs the towers as one grouped bank
(``steps.make_infer_step``'s knob; the JAX manager has no such keyword,
its step takes it). ``CERBERUS_PAIRED`` is read when a step is bound.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import ModelConfig
from ..models.convert import load_checkpoint, state_dict_from_jax_params
from ..models.net_desc import NetDesc, init_weights
from ..parallel.mesh import make_sharded_infer_step, normalize_device
from ..utils.debug import default_device
from .steps import make_infer_step


def resolve_device(device=None) -> torch.device:
    """``None`` means ``CERBERUS_DEFAULT_DEVICE`` where it is set, else the
    card (``cuda``); raises when CUDA is absent."""
    if device is None:
        device = default_device() or "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


class InferManager:
    def __init__(self, checkpoint_path: Optional[str] = None,
                 decoder_dict: Optional[dict] = None,
                 model_args: Optional[dict] = None,
                 device=None, params: Optional[dict] = None, mesh=None,
                 **kwargs):
        """On the card the forward computes in bf16 and the canvas is f16
        (the JAX package's numerics policy); on the CPU both are f32.
        ``mesh``: None or a single-controller mesh (its first device is
        the manager's)."""
        self.checkpoint_path = checkpoint_path
        self.decoder_dict = decoder_dict or {}
        self.model_args = model_args or {}
        if mesh is not None:
            if mesh.group is not None:
                raise ValueError("inference takes a single-controller mesh, "
                                 "not a process mesh")
            if device is not None and normalize_device(
                    resolve_device(device)) != mesh.devices[0]:
                raise ValueError("device %s is not the mesh's first device "
                                 "%s" % (device, mesh.devices[0]))
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        on_card = self.device.type == "cuda"
        self.compute_dtype = torch.bfloat16 if on_card else torch.float32
        self.out_dtype = torch.float16 if on_card else torch.float32
        self.fuse_decoders = False
        for variable, value in kwargs.items():
            setattr(self, variable, value)
        self.cfg = ModelConfig.from_kwargs(self.model_args)
        model = NetDesc(self.cfg)
        if params is not None:
            model.load_state_dict(state_dict_from_jax_params(params),
                                  strict=True)
        elif self.checkpoint_path is None:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(load_checkpoint(self.checkpoint_path),
                                  strict=True)
        self.model = model.to(self.device).eval()
        self._step_cache: Dict[object, Callable] = {}

    def run_step(self, batch: torch.Tensor, output_shape: int) -> torch.Tensor:
        """uint8 NHWC batch on the device -> (N, out, out, C) tensor; with
        a mesh the batch is sharded over it (any batch size)."""
        if output_shape not in self._step_cache:
            if self.mesh is not None:
                self._step_cache[output_shape] = make_sharded_infer_step(
                    self.model, self.cfg, self.mesh, output_shape,
                    self.compute_dtype, self.out_dtype)
            else:
                self._step_cache[output_shape] = self._device_step(
                    output_shape)
        return self._step_cache[output_shape](batch)

    def device_step(self, batch: torch.Tensor,
                    output_shape: int) -> torch.Tensor:
        """``run_step`` on the manager's device alone, mesh or not (the
        fused tile backend's step, as JAX's ``run_fused_tile`` reads no
        mesh)."""
        if self.mesh is None:
            return self.run_step(batch, output_shape)
        key = ("device", output_shape)
        if key not in self._step_cache:
            self._step_cache[key] = self._device_step(output_shape)
        return self._step_cache[key](batch)

    def _device_step(self, output_shape: int) -> Callable:
        return make_infer_step(self.model, self.cfg, output_shape,
                               self.compute_dtype, self.out_dtype,
                               fuse_decoders=self.fuse_decoders)
