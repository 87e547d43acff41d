"""The XLA indexing semantics that the JAX package relies on, in PyTorch.

- ``top_k``: ``lax.top_k`` returns equal values lower index first.
  ``torch.topk`` promises no order among ties, and its order differs between
  the CPU and CUDA. Ties are the rule wherever the JAX package ranks a 0/1
  score or a count (the NMS scores, the local-map harvest, covisibility
  neighbours), and the order of the selected rows decides later argmin ties,
  so every top k of the port is this stable sort.
- ``put`` / ``add``: ``x.at[idx].set(v, mode="drop")`` and ``.add``. A row
  is dropped by routing it to a pad row past the end of dimension 0, which is
  cut off afterwards. Where several kept rows name one element, a set takes
  the last row, as XLA's serial scatter on the CPU does; ``index_put_`` on a
  card promises nothing there, so ``last_writer`` first keeps only that row.
  An add accumulates every kept row.

Nothing here reads a value back to the host, and every function returns a
new tensor: the caller's input is never written.
"""

from __future__ import annotations

import math

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def take(x: torch.Tensor, k) -> torch.Tensor:
    """x[k] for a Python int or a 0-d/1-element index tensor, clipped to
    the first dimension. A 0-d tensor is read as a 1-element gather: indexing
    with it directly would read it back to the host."""
    n = x.shape[0]
    if isinstance(k, torch.Tensor):
        return x[k.reshape(1).long().clamp(0, n - 1)][0]
    return x[min(max(int(k), 0), n - 1)]


def rows_of(k, n: int, device) -> torch.Tensor:
    """A Python int or a 0-d/1-element tensor -> an int64 tensor [n] of it."""
    if isinstance(k, torch.Tensor):
        return k.reshape(1).to(device=device, dtype=torch.int64).expand(n)
    return torch.full((n,), int(k), dtype=torch.int64, device=device)


def route(n: int, idx: tuple, keep: torch.Tensor) -> tuple:
    """The index tuple with every row outside ``keep`` sent to the pad row
    ``n`` of dimension 0 (and to 0 in the other indexed dimensions)."""
    first = torch.where(keep, idx[0].long(), n)
    return (first,) + tuple(torch.where(keep, i.long(), 0) for i in idx[1:])


def last_writer(sizes: tuple, idx: tuple, ok: torch.Tensor) -> torch.Tensor:
    """``ok`` kept only on the last ok row of each group of rows that name
    the same element of an array of leading shape ``sizes``."""
    key = idx[0].long()
    for j in range(1, len(idx)):
        key = key * sizes[j] + idx[j].long()
    m = math.prod(sizes[:len(idx)])
    key = torch.where(ok, key, m)
    row = torch.arange(ok.shape[0], device=ok.device)
    last = torch.full((m + 1,), -1, dtype=torch.int64, device=ok.device
                      ).scatter_reduce(0, key, row, "amax")
    return ok & (last[key] == row)


def _values(x: torch.Tensor, tgt: tuple, val) -> torch.Tensor:
    shape = tgt[0].shape + x.shape[len(tgt):]
    if isinstance(val, torch.Tensor):
        return val.to(dtype=x.dtype, device=x.device).expand(shape)
    return torch.full(shape, val, dtype=x.dtype, device=x.device)


def put(x: torch.Tensor, tgt: tuple, val) -> torch.Tensor:
    """A copy of x with x[tgt] = val, where ``tgt`` comes from ``route``
    (its kept rows name distinct elements, or write equal values)."""
    out = torch.cat([x, x[:1]])
    out.index_put_(tgt, _values(x, tgt, val))
    return out[:x.shape[0]]


def add(x: torch.Tensor, tgt: tuple, val) -> torch.Tensor:
    """A copy of x with val added at tgt, accumulating repeated targets."""
    out = torch.cat([x, x[:1]])
    out.index_put_(tgt, _values(x, tgt, val), accumulate=True)
    return out[:x.shape[0]]
