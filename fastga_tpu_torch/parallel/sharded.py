"""The sharded seed pipeline over the ranks of a torch.distributed group.

Port of fastga_tpu/parallel/sharded.py.  The JAX package runs one program
over a mesh of devices (``shard_map``); here every rank calls
``sharded_tubes`` with its own card, and the collectives meet in
``torch.distributed``.  The reference's parallelism (SURVEY §2.5) maps as
in the JAX package:

- P2 (contig/position-space split): genome positions are blocked over the
  ranks; each rank makes the syncmer entry candidates of its block (a
  halo of 32 positions before and 64 after, masked out of the block);
- P1 (k-mer-space split): each rank owns an equal range of the 2^24 k-mer
  prefix space.  A prefix range never splits an adaptamer group (a group
  shares >= 12 bases = 24 bits), so each rank's merge is exact;
- P3 (all-to-all shuffle): candidates go to their prefix owner, and the
  merged seeds to the owner of their A contig, by ``all_to_all_single``;
- P4 (sort + fingers): each rank sorts its fragment and runs the port's
  ``merge_seeds`` / ``self_seeds`` and chain sweep (ops/device_pipeline);
- P7 (deterministic merge): ranks own ascending A-contig-rank ranges and
  emit tubes in host order, so the tubes gathered in rank order are the
  single-device tube order.

Each exchange sends its counts first and sizes the all-to-all to them, so
once a genome is uploaded the route finishes on the devices: the JAX
package's fixed slots and their overflow count (which returns None and
seeds on the host) have no counterpart, nor have its per-shard seed,
alive-row and tube caps.  The declines are the JAX route's, before any
upload: ``device_pipeline.Declined`` with ``decline_reason``'s reason.
An error after upload reaches the caller.

``sharded_tubes`` returns exactly what ops/device_pipeline.device_tubes
(device_tubes_self for one genome) returns; tests/test_torch_sharded.py
holds it against them, the JAX route and the host path.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch
import torch.distributed as tdist

from ..ops import device_pipeline as dp
from ..ops.merge_kernels import lexsort2
from ..utils import prof
from .distributed import gather_host

AXIS = "shards"

HB = 32     # leading halo: the rc k-mer words read up to 28 positions back
HE = 64     # trailing halo: the syncmer and k-mer windows read up to 60 ahead


@dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group as the pipeline's one mesh
    axis: ``size`` ranks, this process's ``rank`` and the ``device`` it
    computes on.  Collectives take their tensors on ``comm_device``: the
    host for gloo, the card for NCCL."""
    size: int
    rank: int
    device: torch.device
    backend: str
    axis: str = AXIS

    @property
    def comm_device(self):
        return (torch.device("cpu") if self.backend == "gloo"
                else self.device)


def make_mesh(n_devices: int, device=None, axis: str = AXIS) -> Mesh:
    """The mesh of the default process group, which must have
    ``n_devices`` ranks.  ``device`` None is this rank's current card."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("make_mesh: no process group (call "
                           "parallel.distributed.init or "
                           "torch.distributed.init_process_group first)")
    if tdist.get_world_size() != n_devices:
        raise ValueError(f"make_mesh: the process group has "
                         f"{tdist.get_world_size()} ranks, not {n_devices}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device is None else torch.device(device))
    return Mesh(n_devices, tdist.get_rank(), dev, tdist.get_backend(),
                axis)


def _exchange(mesh, rows, dest):
    """All-to-all of the rows of ``rows`` ([n, k], one dtype) to rank
    ``dest`` (a row with dest == mesh.size stays behind): the counts go
    first and size the exchange.  A stable sort by destination keeps each
    destination's rows in their order; the received rows come in (source
    rank, row) order."""
    D = mesh.size
    cd = mesh.comm_device
    o = torch.sort(dest, stable=True).indices
    cnt = torch.bincount(dest, minlength=D + 1)[:D]
    send_c = cnt.to(cd)
    recv_c = torch.empty_like(send_c)
    tdist.all_to_all_single(recv_c, send_c)
    sc, rc = cnt.tolist(), recv_c.tolist()
    send = rows[o[:sum(sc)]].to(cd).contiguous()
    out = torch.empty((sum(rc),) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=cd)
    tdist.all_to_all_single(out, send, rc, sc)
    return out.to(rows.device)


def _block_candidates(prep, i0, L, device):
    """The packed entry keys (ka, kb) of the syncmer candidates at the
    positions [i0, i0 + L) of one genome (``prep``: its host tables from
    ``_prep_genome``); the block's packed bases and the contig tables go up,
    with the halo the candidate windows read."""
    bps, coff, clen, invp, nc, N = prep
    lo = i0 - HB
    LH = HB + L + HE
    b0 = min(max(lo, 0), N - 1) >> 2     # a block past this genome's end
    b1 = min((i0 + L + HE + 3) >> 2, N >> 2)
    wb = bps[b0:b1].to(device).to(torch.int64)
    p = lo + torch.arange(LH, dtype=torch.int64, device=device)
    pc = p.clamp(0, N - 1)
    bases = ((wb[(pc >> 2) - b0] >> ((pc & 3) << 1)) & 3).to(torch.int32)
    starts = coff[:nc].to(device).to(torch.int64)
    cont = torch.searchsorted(starts, pc, right=True) - 1
    loc = p - starts[cont]
    ln = clen.to(device)[cont]
    cranks = invp.to(device)[cont]
    in_block = (p >= i0) & (p < i0 + L)
    ok, w0, w1, w2, cc, pp, oo = dp.entry_candidates(bases, loc, ln, cranks,
                                                     in_block)
    return dp.pack_entry_keys(ok, w0, w1, w2, cc, pp, oo), w0, ok


def _fragment_table(ka, kb):
    """Received rows -> this rank's sorted table fragment in the device
    pipeline's T-tuple layout, padded to its rows' bucket."""
    dev = ka.device
    R = ka.shape[0]
    E = dp._pad_bucket(R)
    pad = torch.full((E - R,), dp.I64MAX, dtype=torch.int64, device=dev)
    ka, kb = torch.cat([ka, pad]), torch.cat([kb, pad])
    o = lexsort2(ka, kb)
    w0, w1, w2, cs, ps, os_ = dp.unpack_entry_keys(ka[o], kb[o])
    lcp = dp.adjacent_lcp(w0, w1, w2)
    vs = (torch.arange(E, device=dev) < R).to(torch.int32)
    return (w0, w1, w2, cs, ps, os_, lcp,
            torch.tensor(R, dtype=torch.int64, device=dev), vs)


def _table(mesh, prep, i0, L, span, dev):
    """This rank's table fragment of one genome on ``dev``: the candidates
    of its position block, each sent to the owner of its 24-bit k-mer
    prefix (``(pre24 * D) >> 24``), the received rows sorted."""
    D = mesh.size
    with prof.span(span, dev):
        (ka, kb), w0, ok = _block_candidates(prep, i0, L, dev)
        pre24 = dp._u32_64(w0) >> 8
        dest = torch.where(ok, (pre24 * D) >> 24, D)
    with prof.span("devpipe.exchange", dev):
        got = _exchange(mesh, torch.stack([ka, kb], 1), dest)
    with prof.span(span, dev):
        return _fragment_table(got[:, 0].contiguous(),
                               got[:, 1].contiguous())


def _owner_of_rank(alens_by_rank, D):
    """A-contig rank -> owning rank: contiguous rank ranges balanced by
    bp (the JAX route's map)."""
    cum = np.cumsum(np.asarray(alens_by_rank, np.int64))
    tot = int(cum[-1]) if len(cum) else 1
    return np.minimum((cum - 1) * D // max(tot, 1), D - 1).astype(np.int64)


def sharded_tubes(gdb1, gdb2, alens_by_rank, mesh, freq: int = 10,
                  chain_break: int = 2000, chain_min: int = 170,
                  device=None):
    """(TubeBatch, nseeds, plsum) of a genome pair from the sharded
    pipeline, the same on every rank of ``mesh``, equal to device_tubes /
    the host pipeline; ``device_pipeline.Declined`` when a check before any
    upload or collective declines (contig count, field widths, ``freq``).
    Pass ``gdb2=None`` or ``gdb1`` twice for a self comparison
    (``self_seeds`` on each rank's fragment).  ``device`` None is the
    mesh's."""
    selfish = gdb2 is None or gdb2 is gdb1
    if selfish:
        gdb2 = gdb1
    D = mesh.size
    dev = mesh.device if device is None else torch.device(device)
    lens1 = gdb1.contig_lengths()
    lens2 = lens1 if selfish else gdb2.contig_lengths()
    if (reason := dp.decline_reason((lens1, lens2), freq)):
        raise dp.Declined(reason)
    amax, bmax = int(lens1.max()), int(lens2.max())

    cpu = torch.device("cpu")
    prep1 = dp._prep_genome(gdb1, lens1, cpu)
    prep2 = prep1 if selfish else dp._prep_genome(gdb2, lens2, cpu)
    # one position-block length for both genomes
    L = -(-max(prep1[5], prep2[5]) // D)
    L = ((L + 15) // 16) * 16
    i0 = mesh.rank * L

    T1 = _table(mesh, prep1, i0, L, "devpipe.gix1", dev)
    T2 = None if selfish else _table(mesh, prep2, i0, L, "devpipe.gix2",
                                     dev)
    with prof.span("devpipe.merge", dev):
        if selfish:
            pl, ac, ap, bc, bp, bo, ns, _, plsum = dp._self_seeds_sum(
                T1, 0, freq)
        else:
            pl, ac, ap, bc, bp, bo, ns, _, plsum = dp._merge_seeds_sum(
                T1, T2, 0, freq)
    T1 = T2 = None

    # seeds to the owner of their A contig, in their order
    with prof.span("devpipe.exchange", dev):
        nsh = int(ns)
        owner = torch.as_tensor(_owner_of_rank(alens_by_rank, D),
                                device=dev)
        seeds = torch.stack([pl, ac, ap, bc, bp, bo], 1)[:nsh]
        got = _exchange(mesh, seeds,
                        owner[ac[:nsh].clamp(0, len(owner) - 1).long()])
        cnt = torch.stack([ns.to(torch.int64), plsum.to(torch.int64)])
        cnt = cnt.to(mesh.comm_device)
        tdist.all_reduce(cnt)
    ns2 = got.shape[0]
    cap = dp._pad_bucket(max(ns2, 1 << 13))
    got = torch.cat([got, got.new_zeros((cap - ns2, 6))])
    mout = tuple(got[:, j].contiguous() for j in range(6)) + (
        torch.tensor(ns2, dtype=torch.int64, device=dev), None, None)
    with prof.span("devpipe.chain", dev):
        res, _, _ = dp._run_chain(mout, chain_break, chain_min, amax, bmax,
                                  alens_by_rank, dev)
        cols = torch.as_tensor(np.stack(
            [dp._numpy(x).astype(np.int64) for x in res[:9]], 1))
    with prof.span("devpipe.exchange", dev):
        cat = gather_host(cols.to(mesh.comm_device))
    nseeds, plsum = (int(x) for x in cnt.cpu())
    return dp.tube_batch(*cat.T), nseeds, plsum
