"""Public IVF-PQ list-data helpers (port of
``raft_tpu.neighbors.ivf_pq_helpers``).

Reference: raft/neighbors/ivf_pq_helpers.cuh — the inspection surface over
a built index's per-list storage: :func:`unpack_list_data` (codes out of
the bit-packed list layout), :func:`pack_list_data` (codes back in) and
:func:`reconstruct_list_data` (codes decoded to approximate dataset
vectors).  The pack path returns a new :class:`~raft_tpu_torch.neighbors.
ivf_pq.Index`, the next generation, as the JAX package's does.

Where the two packages differ by design: :func:`pack_list_data` re-decodes
the bf16 recon cache and its norms for the edited rows, as the JAX
package does, and also drops the code scans' row norms
(``list_code_rsq``) and the int8 cache, which the next search that needs
them derives again from the edited codes; the JAX package leaves its code
lanes and int8 cache as they were (stale for the edited rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.core.outputs import auto_convert_output
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.neighbors.ivf_pq import (Index, _decode_rows,
                                             _pack_codes, _unpack_codes)
from raft_tpu_torch.utils import precision


def _row_bounds(index: Index, label: int, offset: int,
                n_rows: Optional[int]) -> int:
    expects(0 <= label < index.n_lists,
            "ivf_pq_helpers: list label out of range")
    size = int(index.list_sizes[label])
    expects(0 <= offset <= size,
            f"ivf_pq_helpers: offset {offset} > list size {size}")
    if n_rows is None:
        n_rows = size - offset
    expects(offset + n_rows <= size,
            f"ivf_pq_helpers: offset+n_rows {offset + n_rows} > list "
            f"size {size}")
    return n_rows


def _labels(index: Index, label: int, n_rows: int) -> torch.Tensor:
    return torch.full((n_rows,), label, dtype=torch.int64,
                      device=index.list_codes.device)


@auto_convert_output
def unpack_list_data(res, index: Index, label: int, *, offset: int = 0,
                     n_rows: Optional[int] = None) -> torch.Tensor:
    """Flat (n_rows, pq_dim) uint8 codes of one list, starting at
    ``offset`` (reference: ivf_pq_helpers.cuh ``unpack_list_data``)."""
    n_rows = _row_bounds(index, label, offset, n_rows)
    packed = index.list_codes[label, offset:offset + n_rows]
    return _unpack_codes(packed, index.pq_dim, index.pq_bits)


def pack_list_data(res, index: Index, label: int, codes, *,
                   offset: int = 0) -> Index:
    """Write flat (n_rows, pq_dim) uint8 codes into one list at
    ``offset`` (reference: ivf_pq_helpers.cuh ``pack_list_data``);
    returns the next generation.  The rows must exist already (``extend``
    adds rows).  The bf16 recon cache and its norms, when attached, are
    re-decoded for the edited rows; the code scans' row norms and the
    int8 cache are dropped, to be derived again from the new codes."""
    codes = ensure_tensor(codes, res, "codes")
    expects(codes.ndim == 2 and codes.shape[1] == index.pq_dim,
            "ivf_pq_helpers.pack_list_data: (n_rows, pq_dim) codes "
            "required")
    n_rows = codes.shape[0]
    _row_bounds(index, label, offset, n_rows)
    codes = codes.to(device=index.list_codes.device, dtype=torch.uint8)
    rows = slice(offset, offset + n_rows)
    list_codes = index.list_codes.clone()
    list_codes[label, rows] = _pack_codes(codes, index.pq_bits)
    upd = dict(list_codes=list_codes, list_code_rsq=None,
               list_recon_i8=None, list_recon_scale=None,
               list_recon_i8_sq=None)
    if index.list_recon is not None:
        recon = _decode_rows(index.codebooks, codes,
                             _labels(index, label, n_rows),
                             index.codebook_kind)
        upd["list_recon"] = index.list_recon.clone()
        upd["list_recon"][label, rows] = recon
        if index.list_recon_sq is not None:
            upd["list_recon_sq"] = index.list_recon_sq.clone()
            upd["list_recon_sq"][label, rows] = (recon.float() ** 2).sum(-1)
    return _mutate.next_generation(index,
                                   dataclasses.replace(index, **upd))


@auto_convert_output
def reconstruct_list_data(res, index: Index, label: int, *,
                          offset: int = 0,
                          n_rows: Optional[int] = None) -> torch.Tensor:
    """Decode one list's codes back to approximate dataset vectors
    (n_rows, dim) float32 (reference: ivf_pq_helpers.cuh
    ``reconstruct_list_data``): the bf16 residual reconstruction plus the
    list's center, rotated back through the orthonormal transform."""
    n_rows = _row_bounds(index, label, offset, n_rows)
    codes = unpack_list_data.__wrapped__(res, index, label, offset=offset,
                                         n_rows=n_rows)
    recon = _decode_rows(index.codebooks, codes,
                         _labels(index, label, n_rows),
                         index.codebook_kind).float()
    x_rot = recon + index.centers[label].float()[None, :]
    with precision.highest():
        return x_rot @ index.rotation.T
