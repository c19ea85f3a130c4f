"""CPU connected components (scipy), for host-side planes.

Counterpart of ``label`` in ``cerberus_tpu/ops/cc_cpu.py:25-28``: the
tissue-mask regions of the WSI gland/lumen phase and the tissue-mask
cleanup are labelled on the host. The rest of the JAX package's CPU oracle
(the ``--postproc_backend=cpu`` families) is not ported yet.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def label(mask: np.ndarray):
    """4-connected component labeling; returns (labels int32, count)."""
    lab, num = ndimage.label(mask)
    return lab.astype(np.int32), num
