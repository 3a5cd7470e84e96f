"""Halo exchange for the row-sharded causal prediction (MED).

Counterpart of ``binary_image_compression_tpu/parallel/halo.py``:
``_pad_rows`` (:21), ``med_forward_sharded`` (:34) and
``med_inverse_sharded`` (:66).  The MED residual of row r reads row r-1
(pred.cpp:6-14), so a page whose rows are split over the ``data`` ranks
needs a one-row halo from the rank above; its inverse is a prefix XOR down
the rows, which crosses ranks as a log-step carry scan.  JAX moves the rows
with ``lax.ppermute`` inside ``shard_map``; here each move is one batch of
point-to-point transfers (``Mesh.permute``).

As in JAX, the page goes in whole and comes out whole: each rank computes
its block of rows from its own rows and what it receives, and the blocks
are all-gathered.  Ragged row counts are zero-padded to a multiple of the
rank count and trimmed: MED is causal, so rows appended below never change
the rows above.
"""

from __future__ import annotations

import torch

from ..ops import bitpack, predict
from .mesh import Mesh


def _pad_rows(x: torch.Tensor, n: int):
    """Zero rows appended so the row count divides n; (x, rows)."""
    rows = x.shape[-2]
    return torch.nn.functional.pad(x, (0, 0, 0, -rows % n)), rows


def _block(mesh: Mesh, x: torch.Tensor):
    n, idx = mesh.shape["data"], mesh.axis_index("data")
    x, rows = _pad_rows(x, n)
    blk = x.shape[-2] // n
    return x[..., idx * blk:(idx + 1) * blk, :], rows


def med_forward_sharded(mesh: Mesh, packed: torch.Tensor,
                        cols: int) -> torch.Tensor:
    """MED residual of a packed page, int32 [rows, nwords(cols)], with its
    rows sharded over 'data': each rank sends its last row down and
    prepends the row it receives (zeros on the first rank)."""
    n, idx = mesh.shape["data"], mesh.axis_index("data")
    x, rows = _block(mesh, packed)
    sends = [(x[-1:], idx + 1)] if idx + 1 < n else []
    recvs = [(x[-1:].shape, x.dtype, idx - 1)] if idx > 0 else []
    got = mesh.permute(sends, recvs, "data")
    halo = got[0].to(x.device) if got else torch.zeros_like(x[-1:])
    r = predict.med_forward(torch.cat([halo, x]), cols)[1:]
    return mesh.all_gather_cat(r, "data")[:rows]


def med_inverse_sharded(mesh: Mesh, residual: torch.Tensor,
                        cols: int) -> torch.Tensor:
    """Inverse MED across row shards: the local prefix XOR along the rows
    and down the block, then the carry of every rank above (the XOR of
    their last rows) by a log-step scan, XORed into every local row."""
    n, idx = mesh.shape["data"], mesh.axis_index("data")
    r, rows = _block(mesh, residual)
    x = predict._prefix_xor_rows(predict._prefix_xor_bits(r))
    last = x[-1:]
    carry = torch.zeros_like(last)
    shift = 1
    while shift < n:
        sends = [(last, idx + shift)] if idx + shift < n else []
        recvs = [(last.shape, last.dtype, idx - shift)] if idx >= shift \
            else []
        got = mesh.permute(sends, recvs, "data")
        if got:
            inc = got[0].to(x.device)
            carry = carry ^ inc
            last = last ^ inc
        shift *= 2
    x = (x ^ carry) & bitpack.trail_mask(cols, x.device)
    return mesh.all_gather_cat(x, "data")[:rows]
