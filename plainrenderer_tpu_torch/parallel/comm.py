"""The band axis as a torch.distributed process group, and a launcher
that runs one function per rank.

The JAX package renders split-frame bands under shard_map and talks
across bands with jax.lax.axis_index / psum / pmin / pmax / all_gather /
ppermute (parallel/sharding.py). Here every band is a process: BandGroup
carries the rank (axis_index), the band count and the collectives the
frame needs (sum_, min_, max_, all_gather), and launch() starts the
ranks.

Device and backend are chosen before the group starts, from the device
count, never by catching an error: rank r renders on cuda:(r % cards)
unless the caller asks for the CPU; the backend is NCCL when every rank
has a card of its own, gloo otherwise (NCCL refuses two ranks on one
device, and the CPU has only gloo). Gloo's collectives run in host
memory, so on CUDA tensors BandGroup stages them explicitly: one copy to
the host (a host sync) and one back per collective (from pinned memory,
queued without a wait), counted in .stats["host_copies"] and named by
.transport ("gloo (host-staged)").
Every band's own work stays on its device. Two-byte floats (bf16, f16)
cross as their int16 bits widened to int32 (gloo has no 16-bit integer
type) and bool as uint8, so any backend carries them bit for bit.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

_BITS_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
              torch.bool: torch.uint8}


class BandGroup:
    """One rank's view of the band axis (the mesh axis of the JAX
    package's shard_map): rank is this band's index, size the band count.

    stats counts, since the last reset_stats(): "collectives" (calls),
    "host_copies" (device<->host copies of the host-staged transport; a
    device-to-host copy is a host sync) and "ms" (host wall time inside
    the collectives, staging included)."""

    def __init__(self, device, pg=None):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.backend = str(dist.get_backend(pg))
        self.device = torch.device(device)
        self.host_staged = (self.backend == "gloo"
                            and self.device.type == "cuda")
        self.transport = self.backend + (" (host-staged)"
                                         if self.host_staged else "")
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"collectives": 0, "host_copies": 0, "ms": 0.0}

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if x.dtype in _BITS_VIEW:
            x = x.view(_BITS_VIEW[x.dtype])
            if x.dtype == torch.int16:
                x = x.to(torch.int32)
        if self.host_staged:
            self.stats["host_copies"] += 1
            x = x.cpu()
        return x

    def _receive(self, x: torch.Tensor, dtype) -> torch.Tensor:
        if self.host_staged:
            self.stats["host_copies"] += 1
            x = x.pin_memory().to(self.device, non_blocking=True)
        if dtype in _BITS_VIEW:
            return x.to(_BITS_VIEW[dtype]).view(dtype)
        return x

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        buf = self._send(x.clone() if not self.host_staged else x)
        dist.all_reduce(buf, op=op, group=self.pg)
        out = self._receive(buf, x.dtype)
        self.stats["collectives"] += 1
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """psum: the elementwise sum of x over the bands."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def min_(self, x: torch.Tensor) -> torch.Tensor:
        """pmin: the elementwise minimum of x over the bands."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """pmax: the elementwise maximum of x over the bands."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """all_gather(tiled=True): every band's x concatenated along dim,
        band 0 first. x has the same shape on every band."""
        t0 = time.perf_counter()
        buf = self._send(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.pg)
        out = self._receive(torch.cat(parts, dim=dim), x.dtype)
        self.stats["collectives"] += 1
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out


def pick_backend(n_ranks: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def _rank_main(rank, n_ranks, backend, device_type, run_dir, pg_timeout,
               fn, args):
    """One rank (the entry that launch() spawns): one thread (ranks share
    the host's cores), join the group, pin the device, wait until every
    rank has joined, run fn(group, *args) and save what it returns for the
    launcher.

    The wait matters: gloo's init_process_group can return on one rank
    while a peer is still completing its side of the connections; a rank
    whose fn makes no collective would then destroy the group (closing
    those sockets) under the peer, whose init fails with "Connection
    closed by peer"."""
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(run_dir, 'store')}",
        world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        dist.barrier()
        result = fn(BandGroup(device), *args)
        torch.save(result, os.path.join(run_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, args=(), device="cuda", timeout: float = 300.0,
           pg_timeout: float = 90.0) -> list:
    """Run fn(group, *args) on n_ranks spawned processes and return what
    each rank's fn returned (rank order; pass tensors on the CPU, both
    ways: a rank moves its inputs to group.device).

    fn must be importable by name from a module that imports no JAX (a
    spawned rank imports it afresh). The group joins over a file store in
    a fresh temporary directory (no port to collide on), with pg_timeout
    seconds for every collective. A rank that raises makes launch() raise
    with its traceback, the other ranks killed; ranks that have not all
    ended after `timeout` seconds are killed and launch() raises
    TimeoutError. It never waits past `timeout`."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("band ranks asked for CUDA but "
                           "torch.cuda.is_available() is false")
    backend = pick_backend(n_ranks, device_type)
    run_dir = tempfile.mkdtemp(prefix="plain_bands_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(n_ranks, backend, device_type, run_dir,
                              pg_timeout, fn, tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.05, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(
                    f"{n_ranks} band ranks still running after {timeout} s")
        return [torch.load(os.path.join(run_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
