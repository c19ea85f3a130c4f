"""The ``wsi_cohort`` driver, with each INST gap also read against a
yardstick of the seed's own: the plain reference computed in the
configuration's bfloat16 (every convolution's input, weight and output
rounded to it, float32 arithmetic between) on the same sampled windows.

``inst_mean_gap_rel`` is ``inst_mean_gap`` over that reference's own
mean gap, ``inst_window_gap_rel`` is ``inst_window_gap`` over its worst
window's. They are for a model whose gap level swings with its weights:
under the DSF-CNN recipe (``dsf_served``) the program's gap moves 15x
from seed to seed, so no fixed limit on the gap itself lies both above
every sound run and below every float8 control. A program that rounds as
bfloat16 does reads near 1 on every seed; the float8 e4m3 control, three
mantissa bits where bfloat16 has seven, reads near 2**4 = 16 times its
seed's bfloat16 gap. The absolute gaps and the yardstick's are printed
beside them.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import wsi_cohort
from portbench.reference.model import Net, channel_map, forward_windows


class Bf16Net(Net):
    """The reference with every convolution's input, weight (a G-conv's
    synthesised kernel) and output rounded to bfloat16."""

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float()

    def conv(self, x, name, stride=1, bias=True, padding=None):
        return self._q(super().conv(x, name, stride, bias, padding))

    def gconv(self, x, name):
        return self._q(super().gconv(x, name))


def rel_gaps(out: dict, yard: dict) -> dict:
    """``out``'s two INST gaps over the yardstick's (both as
    ``window_gap_sums`` returns them)."""
    return {"inst_mean_gap_rel": out["inst_mean_gap"]
            / max(yard["mean"], 1e-30),
            "inst_window_gap_rel": out["inst_window_gap"]
            / max(yard["window"], 1e-30)}


def window_gap_sums(got, ref, chans) -> dict:
    """The mean INST gap over every window of ``got`` against ``ref`` and
    the worst window's own mean, as ``wsi_cohort.Driver.check`` counts
    them."""
    total, n, worst = 0.0, 0, 0.0
    for g, r in zip(got, ref):
        _, ws, wn, _, _ = wsi_cohort.window_gaps(g, r, chans)
        total, n = total + ws, n + wn
        worst = max(worst, ws / max(wn, 1))
    return {"mean": total / max(n, 1), "window": worst}


class Driver(wsi_cohort.Driver):
    def __init__(self, cell):
        super().__init__(cell)
        self._yard = None

    def yardstick(self) -> dict:
        """The bfloat16 reference's gaps on the windows that ``check``
        samples (the same seeded draw a slide), computed once a run."""
        if self._yard is None:
            cfg, chk = self.config, self.traffic["check"]
            win_in, win_out = int(cfg["patch_input"]), int(cfg["patch_output"])
            margin = (win_in - win_out) // 2
            sd = {k: v.to(self.dev) for k, v in self.weights.items()}
            net = Net(sd, cfg["encoder"], cfg["decoders"])
            low = Bf16Net(sd, cfg["encoder"], cfg["decoders"])
            got, ref = [], []
            for k, slide in enumerate(self.slides):
                rng = np.random.default_rng([self.cell.seed % 2 ** 63, 101,
                                             k])
                wins = slide["windows"]
                pick = np.sort(rng.choice(len(wins), min(
                    int(chk["windows"]), len(wins)), replace=False))
                inputs = np.stack([wsi_cohort.input_window(
                    slide["truth"], x - margin, y - margin, win_in)
                    for x, y in wins[pick]])
                ref.extend(forward_windows(net, inputs, win_out, self.dev))
                got.extend(forward_windows(low, inputs, win_out, self.dev))
            self._yard = window_gap_sums(got, ref,
                                         channel_map(cfg["decoders"]))
        return self._yard

    def check(self, precision: str = "f32") -> dict:
        out = super().check(precision)
        yard = self.yardstick()
        out.update(rel_gaps(out, yard))
        out["bf16_mean_gap"], out["bf16_window_gap"] = (yard["mean"],
                                                        yard["window"])
        return out
