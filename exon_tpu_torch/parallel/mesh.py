"""The mesh of shards that distributed execution runs over.

Counterpart of exon_tpu/parallel/mesh.py. There a mesh is a
``jax.sharding.Mesh`` of devices with a ``shard`` axis; here a ``Mesh`` is
``n_shards`` logical shards in each process, laid out in order on the
process's cards (several shards share a card when there are fewer cards
than shards: on one H100 every shard is on ``cuda:0``), or all on the CPU
for a CPU session. Shard ``s`` of process ``p`` is global shard
``p * n_local + s``, so each process's shards are contiguous, as
``make_mesh`` orders the JAX package's global device list (:68-72). The
JAX package's dev/test fallback to virtual CPU devices (:77-85) is not
copied: a CUDA session never puts a shard on the CPU.

Multi-process runs go through ``torch.distributed``: ``init_distributed``
reads ``EXON_TPU_COORDINATOR`` (host:port), ``EXON_TPU_NUM_PROCESSES`` and
``EXON_TPU_PROCESS_ID`` (or its arguments) and starts a process group over
``tcp://``, NCCL for a CUDA session and gloo for a CPU one. Scans split
their file lists per process with ``iter_scan_files`` under
``scan_shard_context``, so every process decodes only ``files[p::P]``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this has lost a peer
_TIMEOUT = datetime.timedelta(seconds=300)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Start the process group of a multi-process run (exon_tpu/parallel/
    mesh.py:38). Arguments fall back to the ``EXON_TPU_*`` variables;
    without a coordinator and a process count this is a single process and
    nothing starts. Under NCCL (a CUDA ``device``) process p first makes
    card ``p % cards`` its current device, where the collectives of the
    host data plane (``all_gather_object``) put their tensors. Returns True
    when more than one process runs. Safe to call more than once."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or \
        os.environ.get("EXON_TPU_COORDINATOR")
    if num_processes is None and "EXON_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EXON_TPU_NUM_PROCESSES"])
    if process_id is None and "EXON_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EXON_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a multi-process run needs a coordinator address, "
                         "a process count and a process id")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)
    return num_processes > 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards: ``devices[s]`` holds local shard ``s``."""

    devices: tuple
    n_processes: int = 1
    process_index: int = 0

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Shards over every process."""
        return self.n_local * self.n_processes

    @property
    def first_shard(self) -> int:
        """The global number of this process's shard 0."""
        return self.process_index * self.n_local

    @property
    def comm_device(self) -> torch.device:
        """Where tensors sit for a collective: the card under NCCL, the CPU
        under gloo."""
        return self.devices[0]


def _cards(device: torch.device) -> list:
    if device.type != "cuda":
        return [device]
    if device.index is not None:
        return [device]
    n = torch.cuda.device_count()
    if process_count() > 1:
        return [torch.device("cuda", process_index() % n)]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_shards: Optional[int] = None, device="cuda") -> Mesh:
    """``n_shards`` shards in this process (0 or None: one a card, one on
    the CPU), dealt over the process's cards in order."""
    cards = _cards(torch.device(device))
    n = n_shards or len(cards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    devices = tuple(cards[i * len(cards) // n] for i in range(n))
    return Mesh(devices, process_count(), process_index())


def local_shard_count(mesh: Mesh) -> int:
    """Shards of this process (exon_tpu/parallel/mesh.py:95)."""
    return mesh.n_local


_SCAN_SHARD: contextvars.ContextVar[Optional[tuple]] = \
    contextvars.ContextVar("exon_torch_scan_shard", default=None)


@contextlib.contextmanager
def scan_shard_context(index: int, count: int):
    """While active, ``iter_scan_files`` yields only this process's slice
    of each scan's file list (round-robin by position)."""
    tok = _SCAN_SHARD.set((index, count))
    try:
        yield
    finally:
        _SCAN_SHARD.reset(tok)


def iter_scan_files(files: Sequence) -> list:
    """The active process file-shard of a scan's file list: process p
    decodes files[p::P]; the whole list outside a shard context. Providers
    call this when their scan starts decoding."""
    shard = _SCAN_SHARD.get()
    if shard is None:
        return list(files)
    index, count = shard
    return list(files)[index::count]
