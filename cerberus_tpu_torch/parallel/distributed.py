"""Multi-process runs: ``torch.distributed`` initialisation and the
multi-host slide queue.

Counterpart of ``cerberus_tpu/parallel/distributed.py:25-61``. The reference
scales across machines by manual job sharding (each invocation takes slides
``[(bulk_idx-1)*step, bulk_idx*step)`` of the sorted list,
``run_infer_wsi.py:89-95``); within one job each process here takes a
strided slice of that job's slides (``shard_slides``), so the CLI flags
keep their meaning and one process is the reference's run. Slides need no
communication beyond initialisation; per-slide skip-if-done lets a re-run
pick up a lost process's slides.

Nothing tells a program here of its cluster: the caller gives the
coordinator's address (``tcp://host:port``), the process count and this
process's rank.
"""
from __future__ import annotations

import datetime
import socket
from typing import List, Optional, Sequence, Tuple

DEFAULT_TIMEOUT_S = 600


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` through a TCP store at
    ``coordinator_address`` (``host:port``, or ``tcp://host:port``),
    which rank 0 serves. A no-op for a single process, or when a group is
    already initialised.

    With CUDA each rank's current device becomes ``cuda:<rank % visible
    cards>``. The ranks publish their card (host and index) through the
    store, and the backend is ``nccl`` when every rank has a card of its
    own, else ``gloo`` (two ranks on one card, or the CPU): NCCL refuses
    two ranks on one card, and gloo moves only ``broadcast`` and
    ``all_reduce`` on CUDA tensors. A rank or a collective that waits
    longer than ``timeout_s`` fails."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id")
    host, port = coordinator_address.split("://")[-1].rsplit(":", 1)
    world, rank = int(num_processes), int(process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timeout)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    card = ""
    if cards:
        torch.cuda.set_device(rank % cards)
        card = "%s:%d" % (socket.gethostname(), rank % cards)
    store.set("card/%d" % rank, card)
    owned = [store.get("card/%d" % r).decode() for r in range(world)]
    backend = ("nccl" if all(owned) and len(set(owned)) == world
               else "gloo")
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)


def process_info() -> Tuple[int, int]:
    """(rank, world size), or (0, 1) when no process group is
    initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_slides(slides: Sequence, masks: Sequence,
                 process_id: Optional[int] = None,
                 process_count: Optional[int] = None
                 ) -> Tuple[List, List]:
    """Strided per-process slice of this job's slide list (after the
    CLI's bulk-idx slicing, so one process gets everything)."""
    if process_id is None:
        process_id, process_count = process_info()
    elif process_count is None:
        # slides[pid::None] would be an OVERLAPPING tail slice: two
        # processes would both take nearly the whole cohort
        raise ValueError("shard_slides: process_count is required when "
                         "process_id is given explicitly")
    return (list(slides[process_id::process_count]),
            list(masks[process_id::process_count]))
