"""Run one function on n ranks of this host, each in its own process.

``run_ranks(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing.spawn``, gives each a process group (gloo by
default) that meets through a file store in a fresh temporary directory
(no port to pick: concurrent calls, as parallel test workers make, cannot
meet in one another's store), calls ``fn(rank, world, *args)`` in each
and returns the ranks' results in rank order.  The CPU
tests run the multi-rank paths this way, and ``chip_smoke.py`` runs two
ranks on one card with it.  ``fn`` and its arguments and result are
pickled, so ``fn`` must be a module-level function; results are pickled
by value (a CPU tensor too, so the rank may exit before the parent reads
it).  A rank that raises makes the call raise
``torch.multiprocessing.ProcessRaisedException`` with its traceback, and
the other ranks are ended (``spawn``'s rule).  Where a peer fails after it
(a collective whose partner has gone), the error raised is still that of
the rank whose ``fn`` raised first.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from sdag_tpu_torch.core.mesh import release_mesh_groups


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Failed:
    """The traceback of a rank whose ``fn`` raised."""

    def __init__(self, trace: str):
        self.trace = trace


def _rank_main(rank: int, world: int, store: str, port: int, backend: str,
               threads: Optional[int], fn: Callable, args, results) -> None:
    if threads is not None:
        import torch
        torch.set_num_threads(threads)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        try:
            out = fn(rank, world, *args)
        except BaseException:
            # reported before this rank's connections close, so ahead of
            # whatever a peer then fails with
            results.put((rank, _Failed(traceback.format_exc())))
            raise
        # no rank closes its connections while a peer still reads from them
        dist.barrier()
    finally:
        # groups a mesh cached would otherwise outlive the default group
        # and be torn down at interpreter exit
        release_mesh_groups()
        dist.destroy_process_group()
    results.put((rank, pickle.dumps(out)))


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              threads: Optional[int] = 1, timeout: float = 600.0
              ) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process with a process group of ``world`` ranks."""
    results = mp.get_context("spawn").SimpleQueue()
    rendezvous = tempfile.mkdtemp(prefix="run_ranks_")
    try:
        ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                       args=(world, os.path.join(rendezvous, "store"),
                             free_port(), backend, threads, fn, args,
                             results))
        got = {}
        failed = []
        deadline = time.monotonic() + timeout

        def drain():
            # read while the ranks run: a result larger than the pipe's
            # buffer blocks its rank until it is read
            while not results.empty():
                rank, payload = results.get()
                if isinstance(payload, _Failed):
                    failed.append((rank, payload.trace))
                else:
                    got[rank] = pickle.loads(payload)

        try:
            while not ctx.join(timeout=0.5):
                drain()
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                        p.join()
                    raise RuntimeError(
                        f"run_ranks: no result within {timeout}s")
        except mp.ProcessRaisedException as e:
            drain()
            if not failed or failed[0][0] == e.error_index:
                raise
            rank, trace = failed[0]
            raise mp.ProcessRaisedException(
                f"\n\n-- Process {rank} terminated with the following "
                f"error:\n{trace}", rank, ctx.processes[rank].pid) from e
        drain()
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [got[r] for r in range(world)]
