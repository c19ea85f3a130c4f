"""Training data pipeline: patch directories -> MTL batches.

The reference ships GT encoders (loader/targets.py) and augmentations
(loader/augs.py) but NO training dataset class or launcher (SURVEY.md §1:
"complete training engine ... with no top-level training launcher"). This
module completes the path:

  * each sample is a ``.npy``/``joblib .dat`` file holding
    ``{"img": HWC uint8, "ann": HxWxC int (channel per ann code),
    "channels": [code, ...][, "patch_class": int]}`` — or, per the
    dataset.yml layout, per-task subdirectories of such files;
  * ``MTLPatchDataset`` applies photometric augmentation, encodes targets
    with ``gen_targets`` (dummy zero-fills + has/dummy flags for tasks the
    sample lacks), and emits the jit-ready batch dict used by
    train/steps.py: img, per-head int maps, ``<head>#WEIGHT-MAP``s, and the
    (N, n_heads) ``has_target`` mask.

The loader is a plain iterable (works with RunEngine); batches are
assembled on the host with numpy — patch-scale data, no device involvement.
The train step (``train/steps.py``) moves them to the card through pinned
memory.

A copy of ``cerberus_tpu/data/train_loader.py``: the same batch dicts,
order, dtypes and bytes for the same ``seed``. A ``.dat`` sample is read
with ``pickle`` first; joblib is imported only when that fails.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..config import ModelConfig
from ..models.net_desc import head_output_channels
from ..utils import recur_find_ext
from ..utils.fsutils import load_dat
from ..utils.geometry import cropping_center
from . import augs
from .targets import gen_targets

PHOTOMETRIC_AUGS = (augs.gaussian_blur, augs.median_blur, augs.add_to_hue,
                    augs.add_to_saturation, augs.add_to_contrast,
                    augs.add_to_brightness)


def _load_sample(path: str) -> Dict:
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True).item()
    return load_dat(path)


class MTLPatchDataset:
    """Iterable of jit-ready multi-task batches."""

    def __init__(self, file_list: Sequence[str], cfg: ModelConfig,
                 req_target_code: Dict[str, str], input_shape: int,
                 output_shape: Optional[int] = None, batch_size: int = 8,
                 augment: bool = True, seed: int = 0, drop_last: bool = True,
                 shuffle: bool = True):
        self.file_list = list(file_list)
        self.cfg = cfg
        self.req_target_code = dict(req_target_code)
        self.input_shape = int(input_shape)
        self.output_shape = int(output_shape or input_shape)
        self.batch_size = int(batch_size)
        self.augment = augment
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.heads = list(head_output_channels(cfg).keys())

    @classmethod
    def from_dir(cls, data_dir: str, cfg: ModelConfig, req_target_code,
                 **kwargs) -> "MTLPatchDataset":
        files = recur_find_ext(data_dir, [".npy", ".dat"])
        if not files:
            raise ValueError("no training samples under %s" % data_dir)
        return cls(files, cfg, req_target_code, **kwargs)

    def __len__(self):
        if self.drop_last:
            return len(self.file_list) // self.batch_size
        return -(-len(self.file_list) // self.batch_size)

    # ------------------------------------------------------------------
    def _encode_sample(self, sample: Dict):
        img = np.asarray(sample["img"], np.uint8)
        if self.augment:
            fn = PHOTOMETRIC_AUGS[self._rng.integers(len(PHOTOMETRIC_AUGS))]
            img = fn(img, self._rng)
        # center-crop image to the input shape
        img = cropping_center(img, (self.input_shape, self.input_shape))

        channels = list(sample.get("channels", []))
        ann = np.asarray(sample.get("ann",
                                    np.zeros((*img.shape[:2], 0), np.int32)))
        # map head codes onto annotation channel codes: heads are like
        # 'Gland-INST'; annotation channels are tissue-level ('Gland-INST',
        # 'Gland-TYPE', ...) in `channels`
        channel_to_target = {head: code
                             for head, code in self.req_target_code.items()
                             if head != "Patch-Class"}
        targets, has_flag = gen_targets(
            ann, channels, channel_to_target,
            (self.output_shape, self.output_shape))

        per_head = {}
        flags = {}
        emitted = list(targets.keys())
        for code, flag in zip(emitted, has_flag):
            per_head[code] = np.asarray(targets[code])
            if not code.endswith("#WEIGHT-MAP"):
                flags[code] = flag is not None

        if "Patch-Class" in self.heads:
            if "patch_class" in sample:
                per_head["Patch-Class"] = np.array(
                    [[[int(sample["patch_class"])]]], np.int32)
                flags["Patch-Class"] = True
            else:
                per_head["Patch-Class"] = np.zeros((1, 1, 1), np.int32)
                flags["Patch-Class"] = False
        return img, per_head, flags

    def __iter__(self):
        order = np.arange(len(self.file_list))
        if self.shuffle:
            self._rng.shuffle(order)
        n_batches = len(self)
        for b in range(n_batches):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            imgs, heads_acc, flags_acc = [], [], []
            for i in idxs:
                img, per_head, flags = self._encode_sample(
                    _load_sample(self.file_list[int(i)]))
                imgs.append(img)
                heads_acc.append(per_head)
                flags_acc.append(flags)
            batch = {"img": np.stack(imgs)}
            batch["has_target"] = np.array(
                [[float(f.get(h, False)) for h in self.heads]
                 for f in flags_acc], np.float32)
            for key in heads_acc[0]:
                batch[key] = np.stack([h[key] for h in heads_acc]).astype(
                    np.float32 if key.endswith("#WEIGHT-MAP") else np.int32)
            yield batch
