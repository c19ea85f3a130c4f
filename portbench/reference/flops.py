"""Forward FLOPs of one window of a configuration, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference forward on
the meta device (shapes only): convolutions and matrix products at two
FLOPs a multiply-add, a G-convolution's kernel synthesis included; the
elementwise work (batch norm, activations, upsampling, softmax) is not.
The count is the full published forward of a window, whatever part of it
an implementation can skip."""
from __future__ import annotations

from functools import lru_cache

import torch
from torch.utils.flop_counter import FlopCounterMode

from .model import Net, param_specs


@lru_cache(maxsize=None)
def _window_flops(encoder: str, decoders_json: str, win_in: int) -> int:
    import json

    decoders = json.loads(decoders_json)
    sd = {name: torch.empty(shape, device="meta",
                            dtype=torch.int64 if kind == "count"
                            else torch.float32)
          for name, shape, kind in param_specs(encoder, decoders)}
    x = torch.empty((1, 3, win_in, win_in), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        Net(sd, encoder, decoders)(x)
    return int(counter.get_total_flops())


def window_flops(config: dict) -> int:
    """FLOPs of one ``config["patch_input"]``-square window."""
    import json

    return _window_flops(config["encoder"],
                         json.dumps(config["decoders"]),
                         int(config["patch_input"]))
