"""cerberus_tpu_torch: the PyTorch + CUDA port of cerberus_tpu for NVIDIA
Hopper (H100).

Tile inference end to end: ResNet encoder + five U-Net decoder towers +
Patch-Class head (``models/``), per-head activations and the centre-cropped
canvas (``infer/steps.py``), device window gather and stitch
(``infer/tile.py``, ``ops/stitch.py``) and instance post-processing on the
card (``ops/gpu_postproc.py``) with hand-written CUDA kernels for connected
components, the 16384-bin histogram and the marker watershed
(``csrc/``, built at first use by ``ops/cuda_build.py``).

The package imports neither JAX nor anything of ``cerberus_tpu``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
