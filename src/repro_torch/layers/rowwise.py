"""The projection product of a speculative verify block, row for row.

A verify forward multiplies ``b * (k+1)`` rows by each weight where the
sequential decode step multiplies ``b``.  A GEMM library picks its
algorithm, and any split of the reduction, by shape, so row ``j`` of the
taller product may differ in the last bit from the ``b``-row product of the
same inputs, and one bit can move an argmax.  :func:`matmul` keeps the
verify exact: it multiplies all rows at once where that gives every row the
``b``-row product's bits, and otherwise one ``b``-row product a block row,
the sequential step's own call.  Which holds is a property of the shapes,
the layout and the library, so it is asked once a (device, dtype, shapes,
strides) key, on seeded random inputs, and kept in :data:`ROUTES`.  The
question needs a host read: it is answered on the first, eager, call (on the
card, the eager chunk that precedes a capture), never inside a capture.
"""
from __future__ import annotations

import torch

__all__ = ["ROUTES", "batched_rows_equal", "matmul"]

# (device, dtype, b, s, K, N, weight strides) -> True where one (b*s)-row
# product gives every row the bits of the b-row product
ROUTES: dict = {}

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _key(x: torch.Tensor, w: torch.Tensor) -> tuple:
    b, s, k = x.shape
    return (str(x.device), x.dtype, b, s, k, w.shape[1], tuple(w.stride()))


def batched_rows_equal(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x.reshape(b*s, K) @ w`` gives every row the bits of the
    ``(b, K) @ w`` product, for x's shape (b, s, K), dtype and device and w's
    layout: one product of seeded random rows against the ``s`` products of
    ``b`` rows, compared bit for bit.  Cached in :data:`ROUTES`."""
    key = _key(x, w)
    if key not in ROUTES:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the verify product's route for {key} was not asked before "
                               f"the capture; run the step eagerly first")
        b, s, k = x.shape
        gen = torch.Generator(device=x.device).manual_seed(0)
        probe = torch.randn((s, b, k), generator=gen, device=x.device).to(x.dtype)
        whole = probe.reshape(s * b, k) @ w
        rows = torch.cat([probe[j] @ w for j in range(s)])
        bits = _BITS[whole.element_size()]
        ROUTES[key] = bool(torch.equal(whole.view(bits), rows.view(bits)))
    return ROUTES[key]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (b, s, K), w (K, N), each row with the bits of the
    ``b``-row product: one product where :func:`batched_rows_equal`, else
    ``s`` products of ``b`` rows each."""
    if x.shape[1] == 1 or batched_rows_equal(x, w):
        return x @ w
    return torch.stack([x[:, j].contiguous() @ w for j in range(x.shape[1])], dim=1)
