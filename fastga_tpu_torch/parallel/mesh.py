"""Multi-card steps of the alignment pipeline over a torch.distributed
group.

Port of fastga_tpu/parallel/mesh.py.  The reference's parallelism is
intra-box pthreads over shared arrays (SURVEY.md §2.5); over ranks:

- P2 (contig-space split)   -> tubes data-parallel over the ranks
- P1 (k-mer-space split)    -> syncmer scan split over sequence chunks,
                               k-mer histogram summed by all_reduce
- P3 (all-to-all shuffle)   -> seed records sent to their owner rank
                               with all_to_all_single
- P7 (merge to one writer)  -> per-rank stats all_reduced

Each function returns a step that every rank calls with the same global
arrays (as the JAX package's jitted step takes them); a rank computes on
its block, on the mesh's device, and returns its block of the output with
the reduced statistics.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from .sharded import make_mesh as _make_mesh


def make_mesh(n_devices: int, axis: str = "d", device=None):
    """The mesh of the default process group (``n_devices`` ranks)."""
    return _make_mesh(n_devices, device=device, axis=axis)


def _block(mesh, x):
    """This rank's equal share of x's rows."""
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


def _all_reduce(mesh, t):
    t = t.to(mesh.comm_device)
    tdist.all_reduce(t)
    return t.to(mesh.device)


def sharded_wave_step(mesh, spec, cfg):
    """The multi-card wave step: tubes split over the ranks, the sequence
    pool whole on each, per rank wave-0 and one chunk of ``cfg.chunk``
    waves (the wave kernels on the card), and the all_reduced count of
    live tubes.  step(pool, aw, alen, bw, blen, dgmin, dgmax, anti) ->
    (this rank's trim anti [n / size], total live tubes)."""
    from ..ops import wave_kernels as wk

    def step(pool, aw, alen, bw, blen, dgmin, dgmax, anti):
        aw, alen, bw, blen, dgmin, dgmax, anti = (
            _block(mesh, x) for x in (aw, alen, bw, blen, dgmin, dgmax,
                                      anti))
        targs = (aw, alen, bw, blen, torch.full_like(aw, -(1 << 30)),
                 torch.full_like(aw, 1 << 30))
        pool = pool.to(mesh.device)
        st = wk.wave0(pool, targs, dgmin, dgmax, anti, torch.ones_like(aw),
                      cfg.w, +1)
        st, _, _ = wk.wave_chunk(pool, targs, st, spec, +1, cfg.chunk)
        nalive = st[15].to(torch.int64).sum().reshape(1)
        return st[10], _all_reduce(mesh, nalive)[0]

    return step


def sharded_seed_histogram(mesh):
    """The syncmer scan split over the ranks and its 10-bit bucket
    histogram summed over them (the GIXmake distribution phase).
    hist(bases [size, 1, N], lengths [size, 1]) -> this rank's row of the
    [size, 1024] output (every row the sum)."""
    from ..ops import syncmer

    def hist(bases, lengths):
        b = _block(mesh, bases)[0, 0].to(torch.int64)
        ln = _block(mesh, lengths)[0, 0]
        mask = syncmer.syncmer_mask(b, ln)
        n = b.shape[0]
        b10 = ((b[: n - 4] << 8) | (b[1 : n - 3] << 6) | (b[2 : n - 2] << 4)
               | (b[3 : n - 1] << 2) | b[4:])
        h = torch.bincount(b10[: mask.shape[0]][mask], minlength=1024)
        return _all_reduce(mesh, h.to(torch.int32))[None]

    return hist


def sharded_seed_exchange(mesh, nshards: int):
    """P3: each rank sends block j of its seed records, binned by
    destination, to rank j.  exchange(seeds [size, nshards, k, f]) -> this
    rank's block of the output, [1, nshards, k, f]: row j is what rank j
    sent it."""
    if nshards != mesh.size:
        raise ValueError(f"sharded_seed_exchange: {nshards} bins over "
                         f"{mesh.size} ranks")

    def exchange(seeds):
        mine = _block(mesh, seeds)[0].to(mesh.comm_device).contiguous()
        out = torch.empty_like(mine)
        tdist.all_to_all_single(out, mine)
        return out.to(mesh.device)[None]

    return exchange
