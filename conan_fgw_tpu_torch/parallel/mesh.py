"""Data-parallel ranks over ``torch.distributed`` (the port's counterpart of
``conan_fgw_tpu/parallel/mesh.py``).

The JAX package builds a device ``Mesh`` with a ``data`` axis over the
devices, shards the rows of each global batch over it and lets XLA insert
the gradient ``psum``. Here each rank is one process with one device in a
process group: ``launch`` spawns the ranks of one ``--num_devices N``
command, ``initialize_distributed`` joins the group that torchrun's
environment describes (``--distributed``), and ``create_mesh`` returns the
calling process's ``Mesh``. Every rank consumes the same global batch
stream and takes its own row block of each batch (``row_block``,
``shard_batch``, ``rank_packer``), as the JAX ``shard_batch`` does; the
gradient all-reduce and the gathers are in ``parallel/collectives.py``.

The backend is ``nccl`` where each rank owns a card and ``gloo`` on the CPU.
A caller may pass ``gloo`` for ranks on CUDA devices (two ranks sharing one
card): their all-reduce then goes through the host. Nothing picks a backend
by itself and nothing falls back: an init that fails raises.

The JAX module's ``batch_sharding``, ``chunk_batch_sharding``,
``shard_chunk_batch`` and ``replicated_sharding`` are GSPMD sharding specs,
which have no torch counterpart; they serve the stacked ``scan_chunk``
batches, which the port never builds (every ``fit`` steps through CUDA
graphs), so they have no copy here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import tempfile
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conan_fgw_tpu_torch.data.packing import PackedBatch

log = logging.getLogger("conan_fgw_tpu_torch")

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a data-parallel process group: its ``rank`` of ``world``,
    its ``device``, the group's ``backend``, the ``group`` the gradient
    all-reduce runs over and ``host_group``, a gloo group over the same
    ranks for host-side gathers (the group itself where it is gloo)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: dist.ProcessGroup
    host_group: dist.ProcessGroup


def initialize_distributed(backend: str) -> None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the card is
    ``LOCAL_RANK``'s, chosen by ``create_mesh``). An explicit topology whose
    init fails raises: it never falls back to separate single-process runs,
    which would share checkpoint and log paths. Without ``WORLD_SIZE``, or
    in a process that has joined a group already, it does nothing."""
    if dist.is_initialized():
        log.warning("initialize_distributed: a process group is joined already")
        return
    env = os.environ
    if "WORLD_SIZE" not in env:
        log.warning("initialize_distributed: no WORLD_SIZE in the environment; one process")
        return
    missing = [v for v in _TORCHRUN_ENV if v not in env]
    if missing:
        raise RuntimeError(f"initialize_distributed: WORLD_SIZE is set but {missing} are not")
    dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))


def create_mesh(num_devices: int, device="cuda", backend: str | None = None) -> Mesh:
    """This process's ``Mesh`` in the joined group (``launch``,
    ``initialize_distributed``) of ``num_devices`` ranks and, where given,
    ``backend``. ``device`` without an index is the rank's card:
    ``LOCAL_RANK``'s where torchrun set it, else the rank's; an explicit
    index (``cuda:0``) is taken as given, so ranks may share a card."""
    if not dist.is_initialized():
        raise RuntimeError(f"create_mesh({num_devices}): no process group is joined"
                           " (launch or initialize_distributed first)")
    world, rank = dist.get_world_size(), dist.get_rank()
    group_backend = dist.get_backend()
    if world != num_devices:
        raise ValueError(f"create_mesh({num_devices}): the process group has {world} ranks")
    if backend is not None and backend != group_backend:
        raise ValueError(f"create_mesh: backend {backend!r}, the group's is {group_backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank}: {dev} asked for, {torch.cuda.device_count()} CUDA"
                             " device(s) visible")
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    host_group = group if group_backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(rank, world, dev, group_backend, group, host_group)


def _rank_main(rank: int, fn: Callable, world: int, args: tuple, backend: str, device: str,
               threads: int, tmp: str) -> None:
    """One spawned rank of ``launch``: join the group, run ``fn`` and write
    its result for the launching process."""
    torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = fn(create_mesh(world, device, backend), *args)
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, backend: str, device="cuda") -> list:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, each a process started
    with ``spawn`` (``fn`` and ``args`` are pickled: ``fn`` must be a
    module-level function), joined over a ``FileStore`` in a temporary
    directory: no port, no network. Returns the ranks' results in rank
    order. Each rank gets an equal share of this process's torch threads.
    A rank that raises makes this raise once every rank has ended (the
    others are terminated)."""
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="conan_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(fn, world, args, backend, str(device), threads, tmp),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for rank in range(world):
            # written by the ranks above, from this program's own objects
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def row_block(batch_size: int, rank: int, world: int) -> tuple[int, int]:
    """``[lo, hi)``: the rows of a global batch of ``batch_size`` that
    ``rank`` of ``world`` owns (the JAX ``_local_row_block`` of a 1-D mesh in
    device order: contiguous, equal blocks)."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} is not a multiple of {world} ranks")
    per = batch_size // world
    return rank * per, (rank + 1) * per


def shard_batch(pb: PackedBatch, mesh: Mesh) -> PackedBatch:
    """The rank's row block of the host batch ``pb`` (views of its arrays)."""
    lo, hi = row_block(pb.y.shape[0], mesh.rank, mesh.world)
    return PackedBatch(**{f.name: getattr(pb, f.name)[lo:hi] for f in dataclasses.fields(pb)})


def rank_packer(pack: Callable, mesh: Mesh) -> Callable:
    """A packer with ``pack``'s signature that packs only the rank's row
    block of each global batch: ``records`` (at most ``batch_size``) at the
    global batch's ``max_atoms`` and ``batch_size // world`` rows, byte for
    byte ``shard_batch`` of the global batch. The result's ``global_rows``
    is ``len(records)``, the global batch's real molecules, which every
    rank's loss divides by."""

    def pack_block(records, *, max_atoms: int, batch_size: int) -> PackedBatch:
        lo, hi = row_block(batch_size, mesh.rank, mesh.world)
        block = list(records[lo:hi])
        # a block of padding only: pack one record for the shape (and the
        # slot), then zero it, as packing leaves padding rows
        pb = pack(block or list(records[:1]), max_atoms=max_atoms, batch_size=hi - lo)
        if not block:
            for f in dataclasses.fields(pb):
                getattr(pb, f.name).fill(0)
        pb.global_rows = len(records)
        return pb

    return pack_block
