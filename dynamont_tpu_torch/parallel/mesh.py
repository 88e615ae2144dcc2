"""Device lists and multi-process bring-up for data-parallel read
processing (counterpart of dynamont_tpu/parallel/mesh.py).

Resquiggling is embarrassingly parallel over reads: one process sends its
buckets round-robin over a list of devices (the engines' `devices`), and
several processes split the read stream by index (the CLIs'
`--distributed`). Training adds a sum over the devices of one process
(parallel/train_step.py, parallel/ntc_step.py) and, across processes, a
summed all_reduce of the per-read estimates (training/trainer.py), the
counterparts of JAX's psum and process_allgather.

The process group is torch.distributed on the gloo backend: what the
processes exchange is host arrays (JAX's process_allgather of numpy
dicts), and gloo, unlike NCCL, lets two ranks share one GPU.
"""

from __future__ import annotations

import atexit
import contextlib
import os
from datetime import timedelta

import torch

# the longest a collective waits for its peers: a rank that died, or a
# peer that never joined, ends the run with an error after this long
TIMEOUT_S = 1800.0


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices one process runs on (counterpart of make_mesh's device
    list): every visible GPU for "cuda", the one device named otherwise
    ("cuda:N", "cpu")."""
    dev = torch.device(kind)
    if dev.type != "cuda":
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {kind!r} requested but torch sees no CUDA device")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def on_device(device):
    """Context that makes `device` the current CUDA device (nothing for
    the CPU). The kernel wrappers enter it around each library entry: the
    CUDA runtime inside the library launches on, and queries (SM counts,
    attributes), the thread's current device, whatever stream it is
    given."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     required: bool = False) -> bool:
    """Multi-process bring-up (one process per host, or per GPU).

    Cluster parameters come from the arguments, the DYNAMONT_COORDINATOR
    (host:port of rank 0) / DYNAMONT_NUM_PROCESSES / DYNAMONT_PROCESS_ID
    environment variables, or, without a coordinator, torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK ("env://"), in that
    order. With required=True (the CLIs' --distributed) a failed bring-up
    raises RuntimeError instead of leaving a single-process run. Returns
    whether a process group is up; it is destroyed when the process
    exits."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("DYNAMONT_COORDINATOR")
    if num_processes is None and os.environ.get("DYNAMONT_NUM_PROCESSES"):
        num_processes = int(os.environ["DYNAMONT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DYNAMONT_PROCESS_ID"):
        process_id = int(os.environ["DYNAMONT_PROCESS_ID"])
    timeout = timedelta(seconds=TIMEOUT_S)
    try:
        if coordinator is not None:
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id, timeout=timeout)
        else:
            dist.init_process_group(backend="gloo", init_method="env://",
                                    timeout=timeout)
    except Exception as e:
        if required:
            raise RuntimeError(
                "distributed run requested but torch.distributed bring-up "
                f"failed: {e}") from e
        return False
    atexit.register(_destroy)
    return True


def _destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def rank_world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
