"""Multi-process execution of the sharded seed pipeline on torch.distributed.

Port of fastga_tpu/parallel/distributed.py.  The JAX package runs one
program over a mesh of every device of every process; here each process is
one rank that drives one card (PyTorch's idiom), every rank calls the same
functions, and the collectives meet in ``torch.distributed``.  The JAX
``local_device_count`` (virtual devices per process) has no counterpart:
one process drives one card.

Usage, one process per rank (``torchrun --nproc-per-node N script.py`` sets
the variables ``init`` reads):

    from fastga_tpu_torch.parallel import distributed as dist
    dist.init()
    ovls, stats = aligner.align_genomes(g1, g2, mesh=dist.global_mesh())

The backend follows the arguments: NCCL when every rank of a host has a
card of its own, gloo on the CPU (``device="cpu"``, the CPU tests) and for
ranks that share a card.  tests/test_torch_sharded.py spawns gloo ranks on
the CPU and holds the sharded route against the JAX package and the
single-device route.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

# the device ``init`` gave this rank (``global_mesh`` builds on it)
_DEVICE = None


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None, device=None,
         timeout: Optional[float] = None) -> bool:
    """Join the process group of a multi-process run.

    The arguments default to the launcher's variables as ``torchrun`` sets
    them: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` (and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the card of each rank).
    Returns False, and does nothing, when no multi-process configuration is
    present, so a single-process caller may call it unconditionally.

    ``device``: None means this rank's card (``cuda:LOCAL_RANK`` modulo the
    cards of the host, made the current device); "cpu" runs the plain
    kernels.  ``backend`` None takes NCCL when the device is a card and the
    host has a card for every local rank, else gloo.  ``timeout``: seconds
    a collective may wait (torch's default when None)."""
    global _DEVICE
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if process_id is None:
        pid = os.environ.get("RANK")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev = torch.device("cuda" if device is None else device)
    ncard = 0
    if dev.type == "cuda":
        ncard = torch.cuda.device_count()
        if ncard == 0:
            raise RuntimeError(
                "fastga_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % ncard)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and ncard >= local_size
                   else "gloo")
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id, **kw)
    _DEVICE = dev
    return True


def global_mesh():
    """The mesh over every rank of the default process group (the sharded
    pipeline's AXIS), on the device ``init`` chose."""
    from .sharded import make_mesh
    return make_mesh(tdist.get_world_size(), device=_DEVICE)


def is_multiprocess() -> bool:
    return (tdist.is_available() and tdist.is_initialized()
            and tdist.get_world_size() > 1)


def gather_host(x) -> np.ndarray:
    """Every rank's tensor ``x`` (rows may differ in number), concatenated
    along dim 0 in rank order, on every rank as numpy.  The row counts are
    gathered first and the rows padded to the largest."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if not (tdist.is_available() and tdist.is_initialized()):
        return x.cpu().numpy()
    D = tdist.get_world_size()
    # gloo takes host tensors, NCCL the card's
    cd = torch.device("cpu") if tdist.get_backend() == "gloo" else x.device
    x = x.to(cd)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=cd)
    ns = [torch.zeros_like(n) for _ in range(D)]
    tdist.all_gather(ns, n)
    ns = [int(v) for v in ns]
    pad = torch.zeros((max(ns),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=cd)
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(D)]
    tdist.all_gather(parts, pad)
    return torch.cat([p[:k] for p, k in zip(parts, ns)]).cpu().numpy()
