"""Start P ranks of the sharded solver on this machine, each a process
of its own that joins one process group (parallel/comm.py):

    run_ranks(fn, P, args)                      # NCCL, card p for rank p
    run_ranks(fn, P, args, device_type="cpu")   # gloo ranks on the CPU
    run_ranks(fn, P, args, share_card=True)     # gloo ranks on card 0

fn(rank, *args) runs in every rank after the group is joined; it must be
importable by name (a module-level function), since it reaches the
ranks pickled. Every rank forks from one forkserver, a clean process that
imports the solver once and never touches a card, so P ranks start in
about the time of one; each rank writes to the caller's stdout and
stderr as they are at the launch (a forkserver's children would
otherwise write to the server's). The group meets through a FileStore in a temporary
directory, so concurrent launches never race for a TCP port. A rank that
raises makes run_ranks raise after every rank has ended (the others are
stopped when one fails or the time limit passes).

The forkserver and multiprocessing's resource tracker outlive run_ranks,
so that later launches reuse them, and end only some time after the
caller does. A command that must leave no process behind when it exits
(the CLI, dryrun, chip_smoke.py) calls stop_servers() at its end.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from multiprocessing import forkserver, reduction, resource_tracker

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import comm

JOIN_TIMEOUT_S = 900
START_METHOD = "forkserver"


class _CallerStdio:
    """The caller's fds 1 and 2, sent to a rank with its launch."""

    def __init__(self, fds=None):
        self.fds = fds

    def __reduce__(self):
        # pickled in the caller while the rank is launched
        return (_CallerStdio, ((reduction.DupFd(1), reduction.DupFd(2)),))

    def attach(self) -> None:
        """In the rank: make the caller's fds its stdout and stderr."""
        for target, fd in zip((1, 2), self.fds):
            os.dup2(fd.detach(), target)


def _rank_main(fn, rank: int, world: int, store: str, device_type: str,
               share_card: bool, stdio: _CallerStdio, args) -> None:
    stdio.attach()
    # one CPU thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    device = comm.rank_device(device_type, rank, share_card)
    comm.init_process_group(rank, world, f"file://{store}", device,
                            share_card)
    try:
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), device_type: str = "cuda",
              share_card: bool = False,
              timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Run fn(rank, *args) in `world` new processes that form one process
    group on `device_type` ('cuda', the default, or 'cpu');
    share_card=True: gloo ranks on card 0 (parallel/comm.py)."""
    ctx = mp.get_context(START_METHOD)
    ctx.set_forkserver_preload(["mgcfd_tpu_torch.parallel.sharded"])
    with tempfile.TemporaryDirectory(prefix="mgcfd_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, device_type,
                                   share_card, _CallerStdio(),
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{fn.__name__} over {world} ranks failed: exit "
                           f"codes {codes} (the failing rank's traceback "
                           "is on stderr)")


def stop_servers() -> None:
    """Stop the forkserver and the resource tracker that run_ranks started
    in this process, and wait until both have exited (nothing to do when
    none was started). The next run_ranks starts them anew."""
    # the forkserver holds a descriptor of the tracker's pipe, and the
    # tracker ends when every holder has closed it: the server goes first
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
