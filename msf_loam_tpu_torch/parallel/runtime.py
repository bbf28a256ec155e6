"""Process-group bring-up for the distributed port (the counterpart of the
JAX package's ``parallel/runtime.py``, over ``torch.distributed``).

The port runs one process per rank, each with its own device, and issues
its collectives on a process group (``parallel.mesh``). ``initialize``
starts that group from its arguments, else from the JAX package's
``MSF_COORD`` / ``MSF_NUM_PROCESSES`` / ``MSF_PROCESS_ID``, else from
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
A single process with nothing set starts a world of one over a
``file://`` store in a temporary directory. The backend is NCCL for a
CUDA device and gloo for the CPU unless the caller names one; a failed
start raises and is never retried on another backend or device.

    torchrun --nproc_per_node 2 -m msf_loam_tpu_torch.apps.run_slam \\
        --map_shards 2 --selftest            # two ranks, one card each
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("msf_loam_tpu_torch")

DEFAULT_TIMEOUT_S = 120.0


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def local_rank() -> int:
    """This process's rank on its machine (torchrun's ``LOCAL_RANK``)."""
    return _int_env("LOCAL_RANK") or 0


def resolve_device(device=None) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` by default (raises without
    CUDA), or the device named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the distributed port on device 'cuda' needs "
                               "a CUDA device; pass device='cpu' to run the "
                               "plain PyTorch versions over gloo")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
    return dev


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group; returns True for a world of more
    than one process, False for a single process (as the JAX package's
    ``initialize``). ``coordinator`` is ``host:port`` or an init-method URL
    (``tcp://``, ``file://``). A group that is already up is kept."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("MSF_COORD")
    num_processes = num_processes or _int_env("MSF_NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("MSF_PROCESS_ID")
    if not coordinator and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = num_processes or _int_env("WORLD_SIZE")
        if process_id is None:
            process_id = _int_env("RANK")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not coordinator or not num_processes or num_processes == 1:
        if num_processes and num_processes > 1:
            raise RuntimeError(f"{num_processes} processes need a "
                               f"coordinator address")
        store = os.path.join(tempfile.mkdtemp(prefix="msf_pg_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=1, rank=0, timeout=timeout)
        return False
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id or 0), timeout=timeout)
    logger.info("torch.distributed up: rank %d/%d over %s (%s)",
                dist.get_rank(), dist.get_world_size(), backend, coordinator)
    return True


def shutdown() -> None:
    """Tear the default process group down, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
