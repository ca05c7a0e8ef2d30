"""Row reductions: contiguous segment sums over a prefix scan (kernel K3),
a dense index-add and a gather whose backward uses it.

Counterpart of ``geosplatting_tpu/ops/segment_rows.py``. The prefix sum
under ``contiguous_segment_sum`` is the hand-written CUDA kernel K3
(``csrc/segment_rows.cu``, one pass over the data, the same bits from run to
run) for a CUDA tensor and ``torch.cumsum`` (its plain version) for a CPU
tensor.

Route taken by the ``gather_rows`` backward: ``index_add_``. The JAX package
avoided scatter-adds because the TPU serialises them; CUDA float atomics run
at memory speed, so ``dense_index_add`` is a plain ``index_add_`` on both
devices and K3 serves the rasterizer's per-Gaussian reduction only. Every
differentiable gather on the port's main path goes through ``gather_rows``:
the backward of plain advanced indexing on the card sorts the indices and
sums each run of equal indices in one warp, and the padded static budgets
(faces, surface cubes and edges) make runs of 10^5 equal padding indices.

Precision: segment sums are differences of a running f32 prefix, ~1e-4
relative at M ~ 1.5M rows, as in the JAX package.
"""
from __future__ import annotations

import torch



def cumsum_rows_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: inclusive prefix sum along axis 0."""
    return torch.cumsum(values, dim=0)


def cumsum_rows(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0: K3's plain version on any device."""
    return cumsum_rows_plain(values)


def contiguous_segment_sum(
    values: torch.Tensor,   # [M, C]
    starts: torch.Tensor,   # [S] segment start rows
    counts: torch.Tensor,   # [S] segment lengths
) -> torch.Tensor:
    """out[i] = sum(values[starts[i] : starts[i] + counts[i]]); ends past M
    clamp to M (truncated segments sum only their in-range rows)."""
    m = values.shape[0]
    s = cumsum_rows(values)
    s = torch.cat([torch.zeros_like(s[:1]), s])
    lo = starts.long().clamp(0, m)
    hi = (starts.long() + counts.long()).clamp(0, m)
    return s[hi] - s[lo]


def dense_index_add(num_rows: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros((num_rows, C)).index_add_(0, idx, values)``."""
    out = values.new_zeros((num_rows,) + tuple(values.shape[1:]))
    return out.index_add_(0, idx.reshape(-1).long(), values)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.row_shape = tuple(table.shape)
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        num_rows, *row = ctx.row_shape
        return dense_index_add(num_rows, idx, grad.reshape(-1, *row)), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of ``table`` along dim 0, ``idx`` of any shape)
    whose backward is ``dense_index_add``."""
    return _GatherRows.apply(table, idx)
