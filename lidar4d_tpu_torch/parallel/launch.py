"""Start a process group's ranks on this host (torch.multiprocessing, spawn).

`start_ranks` starts ranks `first` .. world - 1, each a fresh process that
joins the group at `init_method` and runs fn(rank, *args); the caller may
be rank 0 itself (`cli.main_lidar4d` is, so that it can return rank 0's
Trainer). `join_ranks` waits for them within a time limit and kills and
reports a rank that failed or hung, and then every other: a rank left alone
in a collective would wait for its peers without end.
"""

import multiprocessing.connection
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_entry(fn, args, rank, world, init_method, backend, threads):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    fn(rank, *args)
    dist.barrier()
    dist.destroy_process_group()


def start_ranks(fn, args, world, init_method, backend, first=0, threads=0):
    """Start ranks first .. world - 1 of a `world`-rank group (fn and args
    must pickle; fn is looked up by its module's name). threads > 0 sets
    each rank's torch thread count. Returns the processes."""
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(first, world):
        p = ctx.Process(target=_rank_entry, name=f"rank {rank}", daemon=True,
                        args=(fn, args, rank, world, init_method, backend, threads))
        p.start()
        procs.append(p)
    return procs


def kill_ranks(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def join_ranks(procs, timeout):
    """Wait up to `timeout` seconds for every process to end; raise if one
    failed or did not end, after killing the others."""
    deadline = time.monotonic() + timeout
    pending = list(procs)
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        multiprocessing.connection.wait([p.sentinel for p in pending], left)
        pending = [p for p in pending if p.exitcode is None]
        if any(p.exitcode != 0 for p in procs if p.exitcode is not None):
            break
    running = [p.name for p in procs if p.exitcode is None]
    kill_ranks(procs)
    failed = [f"{p.name} (exit code {p.exitcode})" for p in procs
              if p.exitcode != 0 and p.name not in running]
    if running or failed:
        raise RuntimeError(f"ranks failed: {failed}; killed while still running after "
                           f"{timeout} s or a failure: {running}")
