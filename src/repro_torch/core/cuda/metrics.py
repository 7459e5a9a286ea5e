"""Device versions of the replica-CSR and interaction metrics.

These mirror the numpy functions of `.._arrayops` with torch tensors on
one device, every reduction going through `segment_sum` / `keyed_sum`
(the CUDA kernel on the card, its plain version on the host).  Dtypes
are explicit: keys and ids int64, weights and bytes float64.  Each
output equals the numpy oracle:

  * integer outputs (replica CSR, reference and pair counts) are
    bit-identical — integer sums do not depend on order;
  * float sums go through `keyed_sum`, whose stable sort keeps the
    stream order of `np.bincount` / `np.add.at`, so the comm matrix is
    bit-identical too.

Inputs may be numpy arrays or tensors; outputs are tensors on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from .segsum import keyed_sum, segment_sum

__all__ = ["as_tensor", "replica_csr", "star_triples", "interaction_from_csr"]


def as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`a` (numpy array or tensor) as a contiguous tensor on `device`."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype).contiguous()


def replica_csr(n: int, p: int, src, dst, assignment, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device version of `_arrayops.replica_csr`.

    Sorts the (vertex, cluster) keys v*p + c, drops repeats, and finds
    each vertex's first key by binary search.  Returns (indptr int64[n+1],
    flat int32[sum |A(v)|]); bit-identical to the numpy version, since both
    are the sorted set of unique keys.
    """
    a = as_tensor(assignment, torch.int64, device)
    key = torch.cat([as_tensor(src, torch.int64, device) * p + a,
                     as_tensor(dst, torch.int64, device) * p + a])
    key = torch.unique(key, sorted=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=device) * p
    indptr = torch.searchsorted(key, bounds)
    return indptr, (key % p).to(torch.int32)


def star_triples(indptr, members, vertex_bytes, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device version of `_arrayops.star_triples`: (owner, replica, bytes).

    The owner of a vertex is its first (lowest) member; every other
    member is one triple of `vertex_bytes[v]` bytes (1 when None).  The
    boolean mask keeps the triples in stream order, the order in which
    the float comm sums must accumulate.
    """
    ip = as_tensor(indptr, torch.int64, device)
    mem = as_tensor(members, torch.int64, device)
    sizes = ip[1:] - ip[:-1]
    seg_id = torch.repeat_interleave(
        torch.arange(sizes.numel(), dtype=torch.int64, device=device), sizes,
        output_size=mem.numel())
    first_pos = ip[:-1][seg_id]
    non_owner = torch.arange(mem.numel(), dtype=torch.int64,
                             device=device) != first_pos
    owners = mem[first_pos[non_owner]]
    replicas = mem[non_owner]
    if vertex_bytes is None:
        b = torch.ones(replicas.numel(), dtype=torch.float64, device=device)
    else:
        b = as_tensor(vertex_bytes, torch.float64, device)[seg_id[non_owner]]
    return owners, replicas, b


def interaction_from_csr(indptr, members, p: int, vertex_bytes,
                         pairwise_cap: int, device: torch.device
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device version of `_arrayops.interaction_from_csr`.

    (comm[P,P], shared[P,P]) from three reductions: the per-cluster
    reference counts over p keys, the owner->replica comm over p^2 keys,
    and the capped pairwise shared counts over p^2 keys.  Owner and
    replica always differ, and pairs are enumerated with x < y, so each
    p^2 matrix has an empty diagonal and symmetrises exactly as M + M.T.
    Both outputs are bit-identical to the numpy version.
    """
    comm = torch.zeros((p, p), dtype=torch.float64, device=device)
    shared = torch.zeros((p, p), dtype=torch.float64, device=device)
    ip = as_tensor(indptr, torch.int64, device)
    mem = as_tensor(members, torch.int64, device)
    if mem.numel() == 0:
        return comm, shared
    # diagonal: vertices referencing each cluster (members unique per seg)
    diag = keyed_sum(mem, torch.ones_like(mem), p)
    shared = shared + torch.diag(diag.to(torch.float64))

    owners, replicas, b = star_triples(ip, mem, vertex_bytes, device)
    if owners.numel():
        sums = keyed_sum(owners * p + replicas, b, p * p).reshape(p, p)
        comm = sums + sums.T

    sizes = ip[1:] - ip[:-1]
    keys = []
    for s in torch.unique(sizes).tolist():
        if s < 2 or s > pairwise_cap:
            continue
        base = ip[:-1][sizes == s]
        iu, ju = torch.triu_indices(s, s, offset=1, device=device)
        x = mem[base[:, None] + iu[None, :]]
        y = mem[base[:, None] + ju[None, :]]
        keys.append((x * p + y).reshape(-1))    # members sorted: x < y
    if keys:
        pair_keys = torch.sort(torch.cat(keys)).values
        cnt = segment_sum(torch.ones_like(pair_keys), pair_keys, p * p)
        pairs = cnt.to(torch.float64).reshape(p, p)
        shared = shared + pairs + pairs.T
    return comm, shared
