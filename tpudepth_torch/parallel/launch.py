"""Process-group start-up for data-parallel training.

Counterpart of ``tpudepth/parallel/launch.py``. Each rank is one process on
one device; a launcher such as ``torchrun --nproc_per_node N`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, every process calls :func:`initialize`, builds the data
axis (``core/mesh.py::create_mesh``) and feeds its shard of the dataset
(``get_training_testing_data(..., shard=rank, num_shards=world)``). NCCL
carries the collectives between cards, gloo between CPU processes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpudepth_torch.core.runtime import DeviceLike, resolve_device

#: what a launcher sets (``torchrun``)
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
#: the size of torch's flight-recorder buffer, by its name and its older one
FLIGHT_RECORDER_ENV = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")


def _init_method(address: Optional[str]) -> str:
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: DeviceLike = None) -> Tuple[int, int]:
    """Join the default process group and return ``(rank, world_size)``.

    A no-op (``(0, 1)``) when no launcher environment and no arguments are
    given, or at a world size of 1 unless ``backend`` is named (a group of
    one runs every collective of the step as the identity, which is how a
    single card exercises the NCCL path). The arguments override the
    launcher's environment: ``coordinator_address`` ``host:port`` or an
    ``init_method`` URL (``tcp://``, ``file://``), ``num_processes`` the
    world size, ``process_id`` the rank.

    ``backend`` defaults to NCCL for a CUDA ``device`` (``None`` means
    CUDA, as everywhere in the port) and to gloo for ``device="cpu"``. On
    CUDA the process first takes the card ``LOCAL_RANK`` (or the rank
    modulo the cards). NCCL without a card raises, as
    ``core/runtime.py::resolve_device`` does.

    Under NCCL torch's flight recorder is off unless the environment sets
    ``TORCH_FR_BUFFER_SIZE`` (or its older name): the train step runs two
    small collectives a BatchNorm, and the recorder's stack trace of each
    costs more host time than the collective itself."""
    if dist.is_initialized():
        return host_shard_info()
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None and backend is None
            and not any(k in env for k in LAUNCHER_ENV)):
        return 0, 1
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    if world <= 1 and backend is None:
        return 0, 1
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl" or dev.type == "cuda":
        resolve_device("cuda")   # raises without a card
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if backend == "nccl" and not any(k in env for k in FLIGHT_RECORDER_ENV):
        env[FLIGHT_RECORDER_ENV[0]] = "0"
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=world, rank=rank)
    return host_shard_info()


def host_shard_info() -> Tuple[int, int]:
    """``(rank, world_size)`` for per-process dataset sharding; ``(0, 1)``
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_device(device: DeviceLike = None) -> torch.device:
    """``device``, or for ``None`` this process's card: ``cuda:LOCAL_RANK``
    under a process group, else ``cuda`` (raises without a card)."""
    if device is None and dist.is_available() and dist.is_initialized():
        cards = max(torch.cuda.device_count(), 1)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % cards))
        device = f"cuda:{local}"
    return resolve_device(device)


def shutdown():
    """Leave the process group, when there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
