"""Multi-process runs on one machine for the port's tests and
``chip_smoke.py``: ``world`` spawned processes joined to one
``torch.distributed`` group through
``cerberus_tpu_torch.parallel.distributed.initialize`` (gloo on 127.0.0.1,
a free port), kept alive between runs so that a module pays the spawn and
the group's start once.

``run_ranks(target, world, args, timeout_s)`` runs ``target(rank, world,
*args)`` on every rank of the pool (``target`` importable by name, its
result picklable) and returns the results in rank order. Each run has its
own timeout. No rank is left behind: when one raises, exits, or the run
passes its timeout, every rank is killed (the others may wait in a
collective), the pool is dropped (the next run starts a new one) and the
run raises. ``close_pools()`` ends the pools; so does the exit of the
process that started them.
"""
import atexit
import os
import queue
import socket
import time
import traceback

_POOLS = {}


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_loop(rank, world, port, tasks, results, parent, timeout_s):
    import torch.distributed as dist

    from cerberus_tpu_torch.parallel.distributed import initialize

    try:
        initialize("127.0.0.1:%d" % port, world, rank, timeout_s)
    except BaseException:  # noqa: BLE001 — the parent fails the run
        results.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                item = tasks.get(timeout=5.0)
            except queue.Empty:
                if os.getppid() != parent:  # the parent is gone
                    return
                continue
            if item is None:
                return
            target, args = item
            try:
                results.put((rank, "ok", target(rank, world, *args)))
            except BaseException:  # noqa: BLE001 — the parent fails the run
                results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world`` ranks in ``spawn`` processes, one task queue each."""

    def __init__(self, world: int, timeout_s: float = 600):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self.procs = [ctx.Process(target=_rank_loop, args=(
            rank, world, port, self.tasks[rank], self.results, os.getpid(),
            timeout_s)) for rank in range(world)]
        for proc in self.procs:
            proc.start()

    def run(self, target, args, timeout_s: float):
        for task in self.tasks:
            task.put((target, args))
        deadline = time.monotonic() + timeout_s
        out = {}
        while len(out) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("ranks %s did not finish in %d s" % (
                    sorted(set(range(self.world)) - set(out)), timeout_s))
            try:
                rank, status, value = self.results.get(timeout=min(left, 1))
            except queue.Empty:
                dead = [p for p in self.procs if p.exitcode is not None]
                if dead:
                    raise RuntimeError("a rank exited with code %s and no "
                                       "result" % dead[0].exitcode)
                continue
            if status != "ok":
                raise RuntimeError("rank %d failed:\n%s" % (rank, value))
            out[rank] = value
        return [out[rank] for rank in range(self.world)]

    def close(self, kill: bool = False) -> None:
        if not kill:
            for task in self.tasks:
                task.put(None)
        for proc in self.procs:
            proc.join(timeout=0 if kill else 10)
            if proc.is_alive():
                proc.kill()
                proc.join()


def run_ranks(target, world: int = 2, args=(), timeout_s: float = 600):
    """``target(rank, world, *args)`` on every rank of this process's pool
    of ``world`` ranks (started here when there is none), results in rank
    order."""
    pool = _POOLS.get(world)
    if pool is None:
        pool = _POOLS[world] = RankPool(world)
    try:
        return pool.run(target, args, timeout_s)
    except BaseException:
        del _POOLS[world]
        pool.close(kill=True)
        raise


@atexit.register
def close_pools() -> None:
    """End every pool of this process (also at its exit)."""
    for pool in _POOLS.values():
        pool.close()
    _POOLS.clear()
