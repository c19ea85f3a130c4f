"""Device ops: stitch, post-processing primitives and families, and the
CUDA kernel wrappers (``cc_label``, ``hist16384``, ``watershed``)."""
