"""Multi-device runs: the device mesh, batch-sharded inference, the
data-parallel train step (``mesh.py``) and the multi-host slide queue
(``distributed.py``). ``torch.distributed`` is imported inside the
functions that need it."""
from .mesh import (
    Mesh,
    make_mesh,
    make_sharded_infer_step,
    make_sharded_train_step,
    replicate_params,
    shard_batch,
)
