"""Patch-classifier evaluation: the tissue-type head's accuracy on a set
of labelled patches (counterpart of ``cerberus_tpu/infer/patch.py``).

Each ``.dat`` file holds ``{"img": (h, w, 3) uint8, "ann": class index}``
(the reference ``PatchDataset`` contract). ``load_patch_dataset`` reads it
with ``pickle`` and falls back to joblib (imported there only) for joblib
payloads. The step is the forward's Patch-Class logits, flattened and
softmaxed (``cerberus_tpu/infer/patch.py:54-59``; the decoder towers do not
feed that head, so only the encoder and the head run), over fixed-size
batches with the last one zero-padded. ``evaluate_classification`` prints
and returns the JAX function's metrics, computed in numpy (the GPU
machine has no sklearn) with sklearn's definitions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.net_desc import patch_class_head
from ..utils import recur_find_ext
from ..utils.fsutils import load_dat
from ..utils.geometry import cropping_center
from .manager import InferManager as BaseInferManager


def load_patch_dataset(file_path_list, input_shape: int):
    """``.dat`` files -> (images (N, s, s, 3) uint8 centre-cropped to
    ``input_shape``, labels (N,))."""
    imgs, labels = [], []
    for path in file_path_list:
        info = load_dat(path)
        imgs.append(cropping_center(np.asarray(info["img"]),
                                    (input_shape, input_shape)))
        labels.append(int(info["ann"]))
    return np.stack(imgs), np.array(labels)


def patch_class_probs(model, imgs: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC batch -> (N, K) f32 softmax of the flattened NHWC
    Patch-Class logits."""
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), torch.autocast(
            device_type=x.device.type, dtype=compute_dtype,
            enabled=compute_dtype != torch.float32):
        _, bottom = model.encode(x)
        logits = patch_class_head(model.decoder_head["Patch-Class"], bottom)
    logits = logits.float().permute(0, 2, 3, 1).reshape(logits.shape[0], -1)
    return torch.softmax(logits, dim=-1)


class InferManager(BaseInferManager):
    """Patch-classification evaluation."""

    batch_size = 32
    patch_input_shape = 144

    def predict_probs(self, imgs: np.ndarray) -> np.ndarray:
        """(N, s, s, 3) uint8 -> (N, K) f32 class probabilities, in
        fixed-size batches, the last one zero-padded."""
        batch_size = int(self.batch_size)
        probs = []
        for start in range(0, len(imgs), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                imgs[start:start + batch_size])).to(self.device)
            valid = chunk.shape[0]
            if valid < batch_size:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (batch_size - valid, *chunk.shape[1:]))])
            probs.append(patch_class_probs(self.model, chunk,
                                           self.compute_dtype)[:valid])
        return torch.cat(probs).cpu().numpy()

    def process_file_list(self, run_args: dict,
                          class_names: Optional[Dict[int, str]] = None):
        for variable, value in run_args.items():
            setattr(self, variable, value)
        file_path_list = recur_find_ext(self.input_dir, [".dat"])
        assert len(file_path_list) > 0, "Not Detected Any Files From Path"
        imgs, true_list = load_patch_dataset(file_path_list,
                                             int(self.patch_input_shape))
        n_classes = dict(self.cfg.decoder_kwargs)["Patch-Class"]["OUT"]
        if class_names is None:
            class_names = {i + 1: str(i + 1) for i in range(n_classes)}
        return evaluate_classification(true_list, self.predict_probs(imgs),
                                       class_names)


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn's ``average_precision_score`` for one binary class (step-wise
    precision over every distinct score, ties as one threshold), with its
    operations in its order."""
    order = np.argsort(-y_score, kind="stable")
    score = y_score[order]
    hits = y_true[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(score))[0], score.size - 1]
    tps = np.cumsum(hits)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    precision = tps / (tps + fps)  # tps + fps = idx + 1 >= 1
    recall = tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def f1_per_class(true_list, pred_list, n_classes: int) -> np.ndarray:
    """sklearn's ``f1_score(average=None, zero_division=0)`` over
    ``range(n_classes)``: 2 tp / (true + predicted), 0 where both are 0."""
    labels = np.arange(n_classes)
    tp = np.array([np.sum((true_list == k) & (pred_list == k))
                   for k in labels], np.float64)
    denom = (np.array([np.sum(true_list == k) for k in labels], np.float64)
             + np.array([np.sum(pred_list == k) for k in labels], np.float64))
    return np.where(denom != 0, 2 * tp / np.where(denom != 0, denom, 1), 0.0)


def confusion_matrix_true(true_list, pred_list, n_classes: int
                          ) -> np.ndarray:
    """sklearn's ``confusion_matrix(normalize="true")`` over
    ``range(n_classes)``: rows divided by their sums, empty rows 0."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    keep = ((true_list >= 0) & (true_list < n_classes)
            & (pred_list >= 0) & (pred_list < n_classes))
    np.add.at(cm, (true_list[keep], pred_list[keep]), 1)
    with np.errstate(all="ignore"):
        cm = cm / cm.sum(axis=1, keepdims=True)
    return np.nan_to_num(cm)


def evaluate_classification(true_list, prob_list, class_names) -> Dict:
    """Print and return per-class AP, accuracy and F1, the overall
    accuracy and the row-normalised confusion matrix
    (``cerberus_tpu/infer/patch.py:78-132``)."""
    true_list = np.asarray(true_list)
    nr_classes = prob_list.shape[-1]
    all_ap = []
    for idx in range(nr_classes):
        true_oneclass = (true_list == idx).astype("int")
        if true_oneclass.sum() == 0:
            continue
        ap = average_precision(true_oneclass, prob_list[..., idx])
        all_ap.append(ap)
        print("%s-AP" % class_names.get(idx + 1, str(idx + 1)), ap)
    print("=" * 40)

    pred_list = np.argmax(prob_list, -1)
    acc_all = float(np.mean(true_list == pred_list))
    all_acc = []
    for idx in range(nr_classes):
        sel = true_list == idx
        if sel.sum() == 0:
            continue
        acc = float(np.mean(pred_list[sel] == idx))
        all_acc.append(acc)
        print("%s-accu" % class_names.get(idx + 1, str(idx + 1)), acc)
    print("=" * 40)

    f1_score = f1_per_class(true_list, pred_list, nr_classes)
    for idx in range(nr_classes):
        print("%s-F1" % class_names.get(idx + 1, str(idx + 1)),
              f1_score[idx])
    print("=" * 40)
    print("ALL-accu", acc_all)
    print("AVG-accu", float(np.mean(all_acc)) if all_acc else float("nan"))
    print("AVG-AP", float(np.mean(all_ap)) if all_ap else float("nan"))
    print("AVG-F1", float(np.mean(f1_score)))
    print("=" * 40)
    conf_mat = confusion_matrix_true(true_list, pred_list, nr_classes)
    print(conf_mat)
    return {
        "acc_all": acc_all,
        "avg_acc": float(np.mean(all_acc)) if all_acc else float("nan"),
        "avg_ap": float(np.mean(all_ap)) if all_ap else float("nan"),
        "avg_f1": float(np.mean(f1_score)),
        "conf_mat": conf_mat,
    }
