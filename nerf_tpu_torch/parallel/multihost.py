"""Process-group set-up, as ``nerf_tpu.parallel.multihost``.

One process drives one device. A run over several processes is the same
training code after:

    from nerf_tpu_torch.parallel.multihost import init_distributed
    init_distributed()            # torch.distributed over NCCL (gloo on the CPU)
    mesh = create_mesh()          # now spans every rank

``torchrun`` sets the environment that ``init_distributed()`` reads
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without it
the run is a single process. There is no fallback: a backend that fails to
start raises, and NCCL is never swapped for gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device: str | torch.device = "cuda") -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: str | torch.device = "cuda") -> None:
    """Initialise ``torch.distributed`` (a no-op when the group exists).

    With no arguments it reads torchrun's environment; without that
    environment the run is a single process and nothing is initialised.
    With explicit arguments (``init_method`` such as
    ``tcp://localhost:29500``, ``world_size``, ``rank``) failures propagate.
    ``backend`` defaults to ``default_backend(device)``; on a CUDA device
    each rank takes card ``LOCAL_RANK`` (default: its rank modulo the cards
    it sees) as its current device."""
    if dist.is_initialized():
        return
    explicit = init_method is not None or world_size is not None
    if not explicit and not all(k in os.environ for k in _TORCHRUN_ENV):
        return
    backend = backend or default_backend(device)
    kwargs = {}
    if explicit:
        kwargs = dict(init_method=init_method or "env://", world_size=world_size,
                      rank=rank)
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK",
                                   (rank if rank is not None
                                    else int(os.environ.get("RANK", 0)))
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend=backend, **kwargs)


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that prints, logs and writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()
