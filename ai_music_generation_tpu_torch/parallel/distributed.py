"""Process-group start-up under ``torchrun``: the port of
``ai_music_generation_tpu/parallel/distributed.py``.

JAX starts every host with one ``jax.distributed.initialize`` call. The
port runs one process per card, as the reference's nanoGPT trainer does
under ``torchrun`` (nanoGPT/train.py:86-99): each process reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, binds
its card (``LOCAL_RANK``) and joins one NCCL group. Gloo serves the CPU
only, when the caller asks for the CPU (the tests' worker processes); a
CUDA caller never gets a gloo group. Every group has an explicit timeout,
so a rendezvous that cannot complete raises instead of hanging.

Without the ``torchrun`` variables (and without arguments) this is a
no-op at world size 1, as JAX's is on one host.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.utils.device import resolve_device

TIMEOUT = datetime.timedelta(seconds=300)


def initialize_distributed(
    device: str = "cuda",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    master_addr: Optional[str] = None,
    master_port: Optional[int] = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> dict:
    """Join the process group that ``torchrun`` (or the arguments)
    describe: NCCL on ``cuda`` (after ``torch.cuda.set_device(LOCAL_RANK)``),
    gloo on ``cpu``; a CUDA device without a card raises. Arguments default
    from the environment. A group that is already up is kept.

    Returns the JAX function's summary: ``process_index``,
    ``process_count``, ``local_devices`` (the devices this process drives:
    1, its card or its CPU) and ``global_devices``."""
    device = resolve_device(device)
    env = os.environ
    rank = rank if rank is not None else _int_env("RANK")
    world_size = world_size or _int_env("WORLD_SIZE")
    master_addr = master_addr or env.get("MASTER_ADDR")
    master_port = master_port or _int_env("MASTER_PORT")
    if not dist.is_initialized() and rank is not None and world_size:
        if master_addr is None or master_port is None:
            raise ValueError(
                "a process group needs MASTER_ADDR and MASTER_PORT (torchrun "
                "sets them)")
        init = f"tcp://{master_addr}:{master_port}"
        if device.type == "cuda":
            local = _int_env("LOCAL_RANK") or 0
            torch.cuda.set_device(local)
            dist.init_process_group(
                "nccl", init_method=init, rank=rank, world_size=world_size,
                timeout=timeout, device_id=torch.device("cuda", local))
        else:
            dist.init_process_group(
                "gloo", init_method=init, rank=rank, world_size=world_size,
                timeout=timeout)
    index, count = process_index(), process_count()
    return {"process_index": index, "process_count": count,
            "local_devices": 1, "global_devices": count}


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The only process that logs and writes (the reference's
    ``master_process``, nanoGPT/train.py:90-95)."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the process group, if there is one: every rank together (a
    barrier first), so that no rank tears down its connections while a
    peer still completes a transfer with it (gloo's sends return before the
    peer has received)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def group_of_one(device: str = "cuda"):
    """A process group of this process alone (world size 1, NCCL on the
    card, gloo on the CPU) on a free localhost port, left on exit: a mesh
    of one device for a run without ``torchrun``."""
    from ai_music_generation_tpu_torch.parallel.worker_smoke import free_port

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    info = initialize_distributed(device, rank=0, world_size=1,
                                  master_addr="localhost",
                                  master_port=free_port())
    try:
        yield info
    finally:
        shutdown()
