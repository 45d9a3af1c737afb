"""State carried across from the JAX package, as numpy, into the port's
tensors and back.

The JAX package's "parameters" are its numpy state: the wave state tuple,
tube arguments, packed sequence pools, TubeBatch columns, AlignSpec tables,
GDB contig arrays, and the seed pipeline's entry tables, seeds and outputs.
Nothing of the JAX package is imported here: the functions take plain numpy
arrays (or objects exposing them).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .io.gdb import GDB
from .ops.chain import TubeBatch
from .ops.wave_ref import AlignSpec
from .utils import synth


def _i32(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, np.int32), device=device)


def state_from_numpy(st18: Sequence[np.ndarray], device) -> tuple:
    """18-entry wave state (V, Thi, Tlo, M, 11 int32 scalar columns,
    alive, fallback, dif) -> tensors; Thi/Tlo keep their uint32 bit
    patterns in int32."""
    if len(st18) != 18:
        raise ValueError(f"expected 18 state entries, got {len(st18)}")
    out = [_i32(a, device) for a in st18[:15]]
    out += [torch.as_tensor(np.array(st18[15], bool), device=device),
            torch.as_tensor(np.array(st18[16], bool), device=device),
            _i32(st18[17], device)]
    return tuple(out)


def state_to_numpy(st) -> tuple:
    """Inverse of state_from_numpy (Thi/Tlo as uint32)."""
    out = []
    for i, t in enumerate(st):
        a = t.detach().cpu().numpy()
        out.append(a.view(np.uint32) if i in (1, 2) else a)
    return tuple(out)


def targs_from_numpy(targs: Sequence[np.ndarray], device) -> tuple:
    """(aw, alen, bw, blen, minp, maxp) -> int32 tensors."""
    if len(targs) != 6:
        raise ValueError(f"expected 6 tube arguments, got {len(targs)}")
    return tuple(_i32(t, device) for t in targs)


def pool_from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """Packed uint32 sequence pool -> int32 bit-pattern tensor."""
    return _i32(np.asarray(words, np.uint32), device)


def tubes_from_arrays(cols: Dict[str, np.ndarray]) -> TubeBatch:
    """TubeBatch from its column arrays (e.g. another TubeBatch's
    ``__dict__``)."""
    names = TubeBatch.__dataclass_fields__
    return TubeBatch(**{k: np.asarray(v) for k, v in cols.items()
                        if k in names})


def spec_from_arrays(ave_corr: float, trace_space: int,
                     freq: Sequence[float], table: np.ndarray = None,
                     score: np.ndarray = None) -> AlignSpec:
    """AlignSpec for the same parameters; when the source tables are
    given, they must equal the rebuilt ones."""
    spec = AlignSpec(ave_corr, trace_space, False, tuple(freq))
    for name, src in (("table", table), ("score", score)):
        if src is not None and not np.array_equal(np.asarray(src),
                                                  getattr(spec, name)):
            raise ValueError(f"AlignSpec.{name} differs from the source")
    return spec


def gdb_from_arrays(contigs: List[np.ndarray], names: List[str]) -> GDB:
    """In-memory GDB over numeric (0-3) contig arrays, one scaffold per
    contig, with the given scaffold names."""
    if len(names) != len(contigs):
        raise ValueError("one name per contig")
    g, _ = synth.to_gdb("", [np.asarray(c, np.uint8) for c in contigs])
    for s, nm in zip(g.scaffolds, names):
        s.header = nm
    return g


def table_from_numpy(T: Sequence, device) -> tuple:
    """A device entry table of the JAX seed pipeline, the 9-tuple (w0, w1,
    w2, cont, post, comp, lcp, n, valid) with None slots, -> int32 tensors
    (None stays None; the count n becomes a 0-d int64 tensor)."""
    if len(T) != 9:
        raise ValueError(f"expected a 9-entry table, got {len(T)}")
    return tuple(
        None if a is None
        else (torch.tensor(int(np.asarray(a)), dtype=torch.int64,
                           device=device) if i == 7 else _i32(a, device))
        for i, a in enumerate(T))


def seeds_from_numpy(seeds: Sequence[np.ndarray], device) -> tuple:
    """(plen, acont, apost, bcont, bpost, bcomp) -> int32 tensors."""
    if len(seeds) != 6:
        raise ValueError(f"expected 6 seed columns, got {len(seeds)}")
    return tuple(_i32(a, device) for a in seeds)


def outputs_to_numpy(out: Sequence) -> tuple:
    """A tuple of the seed pipeline's tensors (entry tables, merge_seeds
    and chain_tubes_dev outputs) -> numpy arrays; 0-d counts become
    Python ints and None stays None."""
    res = []
    for t in out:
        if t is None:
            res.append(None)
            continue
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        res.append(int(a) if a.ndim == 0 else a)
    return tuple(res)
