"""In-process serving API: load once, predict arrays (counterpart of
``cerberus_tpu/predictor.py``).

    predictor = CerberusPredictor.from_model_dir("model/")
    result = predictor.predict_tile(rgb_uint8_image)
    # result["Gland"]["inst_map"], result["Gland"]["inst_info"], ...
    # result["pclass_map"]

It runs the tile engine's per-image path (``InferManager.infer_canvas``:
windows gathered on the card, fixed-size batches with the last one
zero-padded, device stitch) and the post-processing families. Concurrent
``predict_*`` calls from threads are serialised by a lock, so each gives
the result a lone call gives. ``postproc_backend`` defaults to ``gpu`` (the
CUDA families), as the port's CLIs do; the JAX predictor's default is
``cpu``, which this one also takes.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from .config import DEFAULT_TARGET_LIST, ModelConfig, load_settings
from .infer.tile import (
    POSTPROC_BACKENDS,
    InferManager,
    instance_info,
    post_process_canvas,
    post_process_host,
)


class CerberusPredictor:
    def __init__(self, checkpoint_path: Optional[str], model_args: dict,
                 decoder_dict: dict, batch_size: int = 8,
                 patch_input_shape: int = 448, patch_output_shape: int = 144,
                 postproc_backend: str = "gpu", params=None,
                 compute_dtype=None, device=None):
        """``params``: a JAX-layout tree of numpy arrays in place of the
        checkpoint. ``compute_dtype``: the forward's dtype (default bf16 on
        the card, f32 on the CPU). ``device``: ``cuda`` unless the caller
        (or ``CERBERUS_DEFAULT_DEVICE``) says otherwise."""
        if postproc_backend not in POSTPROC_BACKENDS:
            raise ValueError("postproc_backend=%r: use one of %s"
                             % (postproc_backend, POSTPROC_BACKENDS))
        extra = {} if compute_dtype is None else {
            "compute_dtype": compute_dtype}
        self._manager = InferManager(
            checkpoint_path=checkpoint_path, decoder_dict=decoder_dict,
            model_args=model_args, device=device, params=params,
            batch_size=int(batch_size),
            patch_input_shape=int(patch_input_shape),
            patch_output_shape=int(patch_output_shape), **extra)
        self.decoder_dict = decoder_dict
        self.batch_size = int(batch_size)
        self.patch_input_shape = int(patch_input_shape)
        self.patch_output_shape = int(patch_output_shape)
        self.postproc_backend = postproc_backend
        self._lock = threading.Lock()

    @classmethod
    def from_model_dir(cls, model_dir: str, **kwargs) -> "CerberusPredictor":
        paramset = load_settings(model_dir)
        return cls(checkpoint_path=f"{model_dir}/weights.tar",
                   model_args=paramset.model_kwargs,
                   decoder_dict=paramset.req_target_code, **kwargs)

    @property
    def cfg(self) -> ModelConfig:
        return self._manager.cfg

    @property
    def device(self):
        return self._manager.device

    def predict_raw(self, img: np.ndarray) -> np.ndarray:
        """RGB uint8 (H, W, 3) -> stitched raw canvas (H, W, C_total) as a
        host f32 array (softmax foreground probabilities and argmax class
        ids per the canvas channel map)."""
        with self._lock:
            return self._manager.infer_canvas(img).float().cpu().numpy()

    def predict_tile(self, img: np.ndarray, postproc_list=None) -> Dict:
        """RGB uint8 (H, W, 3) -> per-task instance maps, instance
        dictionaries and type maps, and the tissue-class map (the ``.mat``
        payloads, in memory)."""
        postproc_list = list(postproc_list or DEFAULT_TARGET_LIST)
        args = (self.decoder_dict, postproc_list,
                self.cfg.active_decoder_kwargs)
        with self._lock:
            canvas = self._manager.infer_canvas(img)
            if self.postproc_backend == "cpu":
                inst_maps, type_maps, pclass_map = post_process_host(
                    canvas.cpu().numpy(), *args)
            else:
                inst_maps, type_maps, pclass_map = post_process_canvas(
                    canvas, *args)
        inst_infos = instance_info(inst_maps, type_maps, postproc_list)
        result = {}
        for tissue, inst_map in inst_maps.items():
            result[tissue] = {
                "inst_map": inst_map,
                "inst_info": inst_infos.get(tissue, {}),
                "type_map": type_maps.get(tissue),
            }
        result["pclass_map"] = pclass_map
        return result
