"""Process groups for multi-device training: one process per device.

Counterpart of careless_tpu/parallel/distributed.py on torch.distributed.
Each rank runs the same program on its own device (`cuda:r` under NCCL,
the CPU under gloo), formats the same files, builds the same model, keeps
its shard of the rows (parallel/shard.py) and sums its gradients with the
others' in one all_reduce a step (Trainer.train). After that collective
every rank holds the same buffer, so the global gradient norm, the
non-finite guard and Adam run on identical values everywhere: the ranks'
parameters stay bit for bit equal and every rank sees a non-finite Grad
Norm at the same step, so they leave the loop together (the guard of
careless_tpu/parallel/distributed.py:9-12).

Unlike the JAX package's initialize, which carries on in one process when
the cluster does not form, a group that fails to form raises here: the
port never runs quietly on one device when several were asked for.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> None:
    """Form the default process group: NCCL when CUDA is available, gloo
    otherwise, unless `backend` says. With no rank and world size given,
    they and the rendezvous come from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); a `file://` init_method needs no
    port. Any failure to form the group raises."""
    if is_initialized():
        return
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "initialize() without rank and world_size needs torchrun's "
                "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host: torchrun's LOCAL_RANK, else its
    rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def host_observation_slice(n_obs: int, process_id: Optional[int] = None,
                           process_count: Optional[int] = None) -> slice:
    """The contiguous range of n_obs rows that process `process_id` of
    `process_count` holds: ceil(n_obs / count) rows each, the last ones
    shorter or empty (careless_tpu/parallel/distributed.py:48-61). They
    default to this process's rank and the world size."""
    p = rank() if process_id is None else process_id
    n = world_size() if process_count is None else process_count
    per = -(-n_obs // n)
    return slice(min(p * per, n_obs), min((p + 1) * per, n_obs))


def all_reduce_sum(buf: torch.Tensor) -> torch.Tensor:
    """Sum `buf` over the ranks in place, in one collective, and
    return it. Without a process group there is one rank, and nothing to
    sum."""
    if not is_initialized():
        return buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order (pickled; one rank: [obj])."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def _rank_entry(r: int, fn: Callable, world: int, init_method: str,
                backend: str, devices: Sequence[str], threads: int,
                out_dir: str, args: tuple) -> None:
    """A spawned rank: form the group, run fn(rank, world, device, *args)
    and save what it returns for the parent."""
    torch.set_num_threads(threads)
    device = torch.device(devices[r])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(backend, init_method, r, world)
    try:
        result = fn(r, world, device, *args)
        torch.save(result, Path(out_dir) / f"rank{r}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          devices: Optional[Sequence[str]] = None, threads: int = 1,
          store_dir: Optional[str] = None) -> List[Any]:
    """Run fn(rank, world, device, *args) in `world` spawned processes that
    form one process group (`backend`) through a file store in store_dir
    (default: a temporary directory), rank r on devices[r] (default: the
    CPU) with `threads` CPU threads; returns what each rank's fn returned,
    in rank order (saved with torch.save, so keep it to tensors, numpy and
    plain Python). fn must be importable by name (a module-level function
    of this package or of the caller's script). A rank that raises or dies
    stops the others and raises here."""
    import torch.multiprocessing as mp

    devices = list(devices or ["cpu"] * world)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    tmp = tempfile.mkdtemp(dir=store_dir)
    try:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_entry, nprocs=world, start_method="spawn",
                           args=(fn, world, init_method, backend, devices,
                                 threads, tmp, tuple(args)))
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
