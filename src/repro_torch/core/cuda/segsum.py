"""Sorted-segment sum: the CUDA kernel's wrapper, its plain version, and
`keyed_sum`.

The pipeline's device half (`_finalize`'s loads and edge counts, the
interaction graphs, the simulator's per-cluster and per-core times) is
one primitive applied over and over: reduce a value stream by a *sorted*
key stream.  `segment_sum` is that primitive.  On a CUDA tensor it
launches the hand-written kernel `csrc/segsum.cu` (which replaces the JAX
package's Pallas `_segsum_kernel`); on a CPU tensor it runs the plain
version.  There is no other path: a CUDA tensor that the kernel cannot
take raises.

Contract: `segment_ids` is int64 and sorted ascending, and every id lies
in [0, num_segments).  Each segment is summed strictly left to right from
0, so the result is bit-identical to `np.add.at` / `np.bincount` over the
same stream, for float64 and int64 alike.  `validate=True` checks the
sort and range contract (a debug aid: a violation otherwise misreduces
silently).

`launches` counts the calls of `segment_sum` that reach the card, one per
call: the kernel runs as up to two launches (one pass over the stream,
then the long segments), counted once.  A run sets it to 0 and reads it
back to show that a path went through the kernel.  Under a program
capture (`core.op_graph`) each call is one `segment_sum` vertex.
"""
from __future__ import annotations

import torch

from .. import op_graph
from . import _build

__all__ = ["segment_sum", "segment_sum_plain", "keyed_sum"]

launches = 0

_DTYPES = (torch.float64, torch.int64)


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain version: one serial pass over the stream, on the host.

    `index_add_` on a 1-D CPU tensor is a single loop in index order
    (`out[ids[i]] += data[i]` for i = 0, 1, ...), the order of
    `np.add.at`; it does not need the ids sorted.  The inputs are copied
    to the host and the result back to their device, so the plain version
    can be held against the kernel on the same tensors.
    """
    out = torch.zeros(num_segments, dtype=data.dtype)
    out.index_add_(0, segment_ids.cpu(), data.cpu())
    return out.to(data.device)


def _launch(data: torch.Tensor, segment_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    global launches
    lib = _build.load_library()
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum takes CPU or CUDA tensors, "
                         f"not {data.device.type!r}")
    fn = lib.segsum_f64 if data.dtype == torch.float64 else lib.segsum_i64
    m = data.numel()
    out = torch.empty(num_segments, dtype=data.dtype, device=data.device)
    # the long segments' ends and list, written by the kernel itself
    scratch = torch.empty(lib.segsum_scratch_len(m, num_segments),
                          dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):   # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), segment_ids.data_ptr(), m, out.data_ptr(),
                num_segments, scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


@op_graph.kernel_vertex("segment_sum")
def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, validate: bool = False
                ) -> torch.Tensor:
    """Sum `data` into `num_segments` buckets keyed by sorted ids.

    Args:
      data: 1-D contiguous float64 or int64 values.
      segment_ids: 1-D contiguous int64 ids, ascending, parallel to data,
        on the same device.
      num_segments: bucket count (>= 0); empty buckets are 0.
      validate: check the sorted/range contract first.

    Returns a tensor of shape (num_segments,), dtype of `data`, on the
    device of `data`: the kernel's output on a CUDA tensor, the plain
    version's on a CPU tensor.
    """
    if data.dim() != 1 or segment_ids.shape != data.shape:
        raise ValueError("data and segment_ids must be parallel 1-D tensors")
    if data.dtype not in _DTYPES:
        raise TypeError(f"data must be float64 or int64, not {data.dtype}")
    if segment_ids.dtype != torch.int64:
        raise TypeError(f"segment_ids must be int64, not {segment_ids.dtype}")
    if segment_ids.device != data.device:
        raise ValueError("data and segment_ids must be on the same device")
    if not (data.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("data and segment_ids must be contiguous")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")
    m = data.numel()
    if validate and m:
        if bool((segment_ids[1:] < segment_ids[:-1]).any()):
            raise ValueError("segment_ids must be sorted ascending")
        if int(segment_ids[0]) < 0 or int(segment_ids[-1]) >= num_segments:
            raise ValueError("segment_ids must lie in [0, num_segments)")
    if m == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    if data.device.type == "cpu":
        return segment_sum_plain(data, segment_ids, num_segments)
    return _launch(data, segment_ids, num_segments)


def keyed_sum(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
              **kw) -> torch.Tensor:
    """`segment_sum` over *unsorted* keys: stable-sort first.

    The stable sort keeps entries that share a key in stream order, so
    each bucket accumulates in the order of `np.bincount(keys,
    weights=values)` / `np.add.at`, bit for bit.
    """
    sorted_keys, order = torch.sort(keys.to(torch.int64), stable=True)
    return segment_sum(values[order], sorted_keys, num_keys, **kw)
