"""Multi-process setup (rray_tpu parallel/distributed.py) over
torch.distributed.

Call `init_distributed()` once per process. It reads its arguments or
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) and
joins the process group; `global_mesh()` is then the mesh over every
rank, and `render_sharded` on it gives every rank the whole frame, which
`host_local_image` brings to the host for IO (only rank 0 should write
the PNG). Two processes on the CPU, or two ranks on one card, use gloo
(NCCL refuses two ranks on one GPU); with a card per rank, NCCL. The
backend is the caller's choice and never changes by itself.

A job of one process drives several devices without a process group:
`mesh.make_mesh(devices=[...])` is a local mesh, every entry in this
process, run in turn from one thread. It does not combine
with a process group: `make_mesh(devices=...)` raises ValueError once
`init_distributed` has joined one, so a rank drives one device.

    torchrun --nproc-per-node 2 script.py   # script: init_distributed(),
                                            # global_mesh("cpu"), ...
"""
from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from .mesh import make_mesh


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, backend: str = "gloo") -> bool:
    """Join the job's process group if the job has more than one process.

    `coordinator` is "host:port" of rank 0's rendezvous (default
    MASTER_ADDR:MASTER_PORT), `num_processes` the world size (default
    WORLD_SIZE), `process_id` this rank (default RANK). Returns True when
    running multi-process (the group is initialized, or already was);
    False, doing nothing, when the job is a single process."""
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0") or 0)
    if process_id is None:
        process_id = int(env.get("RANK", "0") or 0)
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if not coordinator:
        raise ValueError(f"{num_processes} processes and no coordinator "
                         "address (coordinator= or MASTER_ADDR)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(device="cuda"):
    """The 1-D mesh over every rank of the job, this rank on `device`
    (mesh.local_device: "cuda" is the card of LOCAL_RANK)."""
    return make_mesh(device)


def host_local_image(image) -> np.ndarray:
    """A rendered frame (render_sharded gives every rank the whole of it)
    as a host numpy array."""
    return image.detach().cpu().numpy()
