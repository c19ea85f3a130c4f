"""Serialization helpers for tracked outputs.

Parity target: ``run_utils/callbacks/serialize.py`` — ``fig2data``
(matplotlib figure -> RGB array) and the scalar / confusion-matrix / image
converter registry used to fan tracked values out to console, stats files
and tensorboard. A copy of ``cerberus_tpu/train/serialize.py``
(matplotlib imported where a figure is drawn).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def fig2data(fig) -> np.ndarray:
    """Render a matplotlib figure to an (H, W, 3) uint8 RGB array."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


class _Scalar:
    @staticmethod
    def to_console(value):
        return "%0.5f" % float(value)

    @staticmethod
    def to_json(value):
        return float(value)

    @staticmethod
    def to_tensorboard(writer, name, value, step):
        writer.add_scalar(name, float(value), step)


class _ConfusionMatrix:
    @staticmethod
    def to_console(value):
        return "\n" + np.array_str(np.asarray(value), precision=3)

    @staticmethod
    def to_json(value):
        return np.asarray(value).tolist()

    @staticmethod
    def to_tensorboard(writer, name, value, step):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.imshow(np.asarray(value), cmap="Blues")
        ax.set_title(name)
        writer.add_image(name, fig2data(fig), step, dataformats="HWC")
        plt.close(fig)


class _Image:
    @staticmethod
    def to_console(value):
        return "<image %sx%s>" % np.asarray(value).shape[:2]

    @staticmethod
    def to_json(value):
        return None  # images are not serialized into stats files

    @staticmethod
    def to_tensorboard(writer, name, value, step):
        writer.add_image(name, np.asarray(value), step, dataformats="HWC")


SERIALIZERS: Dict[str, object] = {
    "scalar": _Scalar,
    "conf_mat": _ConfusionMatrix,
    "image": _Image,
}


def serialize(value_type: str, target: str, *args):
    handler: Callable = getattr(SERIALIZERS[value_type], f"to_{target}")
    return handler(*args)
