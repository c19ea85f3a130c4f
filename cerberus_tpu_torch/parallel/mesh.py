"""Device meshes and the sharded steps.

Counterpart of ``cerberus_tpu/parallel/mesh.py:38-138``. The reference ran
single-process ``torch.nn.DataParallel`` over its visible GPUs for
inference; the JAX package puts a 1-D ``data`` mesh over its chips and lets
XLA place the collectives. A ``Mesh`` here is one of two kinds:

  * a **single-controller** mesh (``group`` None): this process drives
    every device of ``devices``. Inference shards each batch over it:
    the weights are replicated once per distinct device, chunk *i* is
    enqueued on device *i* from the calling thread (CUDA work on distinct
    devices overlaps with no thread) and the outputs are gathered on
    ``devices[0]``. A device may repeat (a *virtual* mesh: one card steps
    each chunk in turn, and the CPU tests list the CPU several times);
  * a **process** mesh (``group`` a ``torch.distributed`` process group):
    one process per device, each holding ``devices[rank]``, built by
    ``parallel/distributed.initialize`` and ``make_mesh(group=...)``. The
    data-parallel train step runs on it: batch-statistics BN and the
    batch-joint losses all-reduce across the ranks inside the step, so
    the ranks must run in lockstep, which one controller driving several
    devices in turn cannot do (ROADMAP §3, a divergence of form).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..config import ModelConfig
from ..infer.steps import make_infer_step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (one entry per shard, repeats allowed) and
    ``group`` (None: a single-controller mesh; a process group: a process
    mesh whose rank *r* holds ``devices[r]``). The function called decides
    what is split over it (batch rows, or plane rows in
    ``ops/sharded_cc``)."""

    devices: Tuple[torch.device, ...]
    group: object = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        """This process's entry of a process mesh (0 on a
        single-controller mesh)."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def local_device(self) -> torch.device:
        return self.devices[self.rank]


def normalize_device(dev) -> torch.device:
    """``dev`` as a ``torch.device`` with its index; a CUDA entry needs a
    visible card of that index (no fallback to the CPU)."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("mesh device %s: CUDA is not available; list CPU "
                           "devices to build a mesh on the CPU" % dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError("mesh device %s: %d CUDA device(s) visible"
                         % (dev, torch.cuda.device_count()))
    return torch.device("cuda", index)


def make_mesh(devices: Optional[Sequence] = None, group=None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA device;
    raises when there is none). With ``group`` (a process group, or
    ``"world"`` for the default one after ``distributed.initialize``) it
    is a process mesh: one entry per rank, by default each rank's card
    ``cuda:<rank % visible cards>``."""
    if group is not None:
        import torch.distributed as dist

        if group == "world":
            group = dist.group.WORLD
        ranks = dist.get_process_group_ranks(group)
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: CUDA is not available; pass "
                                   "devices=[...] for a CPU process mesh")
            count = torch.cuda.device_count()
            devices = [torch.device("cuda", r % count) for r in ranks]
        if len(devices) != len(ranks):
            raise ValueError("a process mesh has one device per rank: %d "
                             "devices for %d ranks" % (len(devices),
                                                       len(ranks)))
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(normalize_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, group)


def gpu_flag_devices(gpu_flag: str):
    """The inference CLIs' ``--gpu``: one id -> (``cuda:<id>``, None); a
    comma list (the reference's meaning: DataParallel over those cards) ->
    (the first card, a mesh over the listed cards). Raises where a listed
    card is not visible."""
    ids = [int(g) for g in str(gpu_flag).split(",") if g.strip()]
    if len(ids) == 1:
        return "cuda:%d" % ids[0], None
    mesh = make_mesh([torch.device("cuda", g) for g in ids])
    return mesh.devices[0], mesh


def replicate_params(model: torch.nn.Module, mesh: Mesh
                     ) -> List[torch.nn.Module]:
    """One model per mesh entry: ``model`` itself on its own device, a copy
    on each other distinct device; entries on the same device share one
    replica."""
    own = next(model.parameters()).device
    replicas = {}
    out = []
    for dev in mesh.devices:
        if dev not in replicas:
            replicas[dev] = (model if dev == own
                             else copy.deepcopy(model).to(dev))
        out.append(replicas[dev])
    return out


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The batch split on dim 0 into one chunk per mesh entry, each on its
    entry's device (the copies do not block). The batch must divide by
    the mesh size, as a sharded batch axis requires."""
    n = mesh.size
    if batch.shape[0] % n:
        raise ValueError("batch of %d does not divide over %d devices"
                         % (batch.shape[0], n))
    return [chunk.to(dev, non_blocking=True)
            for chunk, dev in zip(torch.tensor_split(batch, n), mesh.devices)]


def make_sharded_infer_step(model, cfg: ModelConfig, mesh: Mesh,
                            output_shape: int = 144,
                            compute_dtype=torch.bfloat16,
                            out_dtype=torch.float16) -> Callable:
    """Batch-sharded inference step over a single-controller mesh: uint8
    NHWC batch -> (N, out, out, C) on ``mesh.devices[0]``. Any batch size
    works: the batch is zero-padded to a mesh multiple and the first N rows
    come back (the CLIs' default batches of 10 do not divide an 8-card
    host; the reference's DataParallel took any batch). Each chunk runs
    ``infer/steps.make_infer_step``'s step on its replica, so valid-region
    decoding, dense windows and DSF nets work as on one device. A chunk's
    step sees the per-device batch (the padded batch over the mesh size),
    which is what JAX's ``data_parallel=n_dev`` gives the paired-front
    gate of ``CERBERUS_PAIRED=1`` (``cerberus_tpu/parallel/mesh.py:
    70-73``)."""
    if mesh.group is not None:
        raise ValueError("inference shards over a single-controller mesh; "
                         "a process mesh is for the data-parallel train "
                         "step")
    steps = {}
    for dev, replica in zip(mesh.devices, replicate_params(model, mesh)):
        if dev not in steps:
            steps[dev] = make_infer_step(replica, cfg, output_shape,
                                         compute_dtype, out_dtype)
    n_dev = mesh.size
    head = mesh.devices[0]

    def run(imgs: torch.Tensor) -> torch.Tensor:
        n = imgs.shape[0]
        pad = (-n) % n_dev
        if pad:
            imgs = torch.cat([imgs, imgs.new_zeros((pad, *imgs.shape[1:]))])
        outs = [steps[dev](chunk)
                for dev, chunk in zip(mesh.devices, shard_batch(imgs, mesh))]
        out = torch.cat([o.to(head, non_blocking=True) for o in outs])
        return out[:n] if pad else out

    return run


def check_trainable(mesh: Mesh) -> None:
    """Raise ``NotImplementedError`` for a single-controller mesh of more
    than one device: the data-parallel step needs one process per device
    (ROADMAP §3, a divergence of form)."""
    if mesh.group is None and mesh.size > 1:
        raise NotImplementedError(
            "data-parallel training (ROADMAP queue 1 item 7) takes a process "
            "mesh, one process per device: parallel.distributed.initialize, "
            "then make_mesh(group='world'). A single-controller mesh of %d "
            "devices cannot run BN statistics and the batch-joint losses in "
            "lockstep" % mesh.size)


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, loss_kwargs=None,
                            optimizer_kwargs=None,
                            compute_dtype=torch.float32, grad_accum: int = 1,
                            remat=False, return_grads: bool = False, *,
                            model, paired: bool = False):
    """The data-parallel train step on a process mesh: a
    ``train/steps.TrainStep`` on this rank's device whose call takes the
    GLOBAL batch (each rank slices its rows) and equals the single-device
    step on that batch: BN statistics, the batch-joint dice sums and the
    per-head flag sums are all-reduced across the ranks in the forward,
    the gradients once after the backward, and every rank applies the
    same update. ``grad_accum=K`` splits the global batch into K
    microbatches, each split over the ranks; a batch that does not divide
    by ``K x ranks`` raises ``ValueError``. The weights are broadcast from
    rank 0 when the step is built.

    ``paired``: the width-paired training forward, its BN statistics
    spanning the ranks as the unpaired ones do.

    A mesh of one device is the single-device step. A single-controller
    mesh of more than one device raises ``NotImplementedError``: BN and
    the batch-joint losses need the ranks in lockstep, one process each.
    (JAX returns ``(run, init_state, tx)``; here the step holds the model,
    the optimizer and the update count, as the single-device one does.)"""
    from ..train.steps import TrainStep

    check_trainable(mesh)
    model.to(mesh.local_device)
    return TrainStep(model, cfg, loss_kwargs, optimizer_kwargs,
                     compute_dtype, remat, grad_accum, return_grads,
                     group=mesh.group, paired=paired)
