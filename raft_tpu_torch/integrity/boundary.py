"""Boundary validation of the public entry points (port of
``raft_tpu.integrity.boundary``): garbage inputs (NaN / Inf rows,
malformed shapes) are reported where they enter instead of flowing through
the kernels and coming out as wrong-but-plausible neighbours.

Behaviour follows :func:`raft_tpu_torch.config.get_validation_policy`:

``raise``
    One ``isfinite`` reduction over the input and one host sync; a
    non-finite row raises :class:`~raft_tpu_torch.integrity.errors.
    ValidationError` naming the first bad row (``invariant
    "boundary.nonfinite"``, ``coord (row,)``).  The default.
``mask``
    No host sync: non-finite rows are replaced by zeros on the device and
    the per-row validity vector is returned, so callers flag the matching
    *outputs* (:func:`mask_search_outputs`: id -1 and the metric's worst
    distance) — one bad row cannot poison the batch.
``off``
    Every function here returns at once: no added work.

With observability collection on, each guarded input ticks
``integrity.boundary.checks``, a raise ``integrity.boundary.raised`` and a
mask ``integrity.boundary.masked_rows`` by the rows it flagged (one more
host sync, as in the JAX package; collection is off by default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import config
from raft_tpu_torch import observability as obs
from raft_tpu_torch.integrity.errors import ValidationError


def _nonfinite_error(site: str, bad: int) -> ValidationError:
    return ValidationError(
        f"{site}: non-finite values in input row {bad} "
        f"(policy 'raise'; use config.validation_policy('mask') "
        f"to flag rows instead, or 'off' for trusted inputs)",
        invariant="boundary.nonfinite", coord=(bad,))


def guard_nonfinite(x, *, site: str, policy: Optional[str] = None,
                    host: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Policy-driven non-finite guard over the rows of ``x``.

    Returns ``(x, ok_rows)``: ``ok_rows`` is a per-row bool vector under
    policy ``mask`` (callers flag outputs with it) and ``None`` otherwise.
    Non-floating inputs pass through untouched.  ``host=True`` runs the
    same policy in numpy on a host array and returns numpy arrays."""
    p = policy if policy is not None else config.get_validation_policy()
    if p == "off":
        return x, None
    if host:
        return _guard_nonfinite_host(x, site=site, policy=p)
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        return x, None
    if obs.enabled():
        obs.registry().counter("integrity.boundary.checks").inc()
    fin = torch.isfinite(x)
    ok = fin.flatten(1).all(1) if x.ndim >= 2 else fin
    if p == "raise":
        if not bool(ok.all()):                 # the policy's one host sync
            if obs.enabled():
                obs.registry().counter("integrity.boundary.raised").inc()
            raise _nonfinite_error(site, int(torch.argmin(ok.to(
                torch.uint8))))
        return x, None
    shape_ok = ok.reshape(ok.shape + (1,) * (x.ndim - 1))
    clean = torch.where(shape_ok, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    if obs.enabled():
        obs.registry().counter("integrity.boundary.masked_rows").inc(
            int((~ok).sum()))
    return clean, ok


def _guard_nonfinite_host(x, *, site: str, policy: str
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Numpy twin of the device guard: the same policy semantics, no
    device work."""
    x = np.asarray(x)
    if not (np.issubdtype(x.dtype, np.floating)
            or x.dtype.name == "bfloat16"):
        return x, None
    if obs.enabled():
        obs.registry().counter("integrity.boundary.checks").inc()
    ok = np.all(np.isfinite(x.astype(np.float32)),
                axis=tuple(range(1, x.ndim)))
    if policy == "raise":
        if not bool(np.all(ok)):
            if obs.enabled():
                obs.registry().counter("integrity.boundary.raised").inc()
            raise _nonfinite_error(site, int(np.argmin(ok)))
        return x, None
    shape_ok = ok.reshape(ok.shape + (1,) * (x.ndim - 1))
    clean = np.where(shape_ok, x, np.zeros((), x.dtype))
    if obs.enabled():
        obs.registry().counter("integrity.boundary.masked_rows").inc(
            int(np.sum(~ok)))
    return clean, ok


def check_matrix(x, name: str, *, site: str, dim: Optional[int] = None,
                 allow_empty: bool = True, policy: Optional[str] = None,
                 host: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shape and non-finite validation of a 2-D input: rank, column count
    (``dim``) and, unless ``allow_empty``, at least one row (each a
    :class:`ValidationError` under ``raise`` and ``mask``; nothing under
    ``off``), then :func:`guard_nonfinite`.  Returns what that returns."""
    p = policy if policy is not None else config.get_validation_policy()
    if p == "off":
        return x, None
    xs = tuple(np.shape(x) if not hasattr(x, "shape") else x.shape)
    if len(xs) != 2:
        raise ValidationError(
            f"{site}: {name} must be 2-D, got shape {xs}",
            invariant="boundary.rank")
    if dim is not None and xs[1] != dim:
        raise ValidationError(
            f"{site}: {name} has {xs[1]} columns, expected {dim}",
            invariant="boundary.dim")
    if not allow_empty and xs[0] == 0:
        raise ValidationError(f"{site}: {name} has no rows",
                              invariant="boundary.empty")
    return guard_nonfinite(x, site=site, policy=p, host=host)


def mask_search_outputs(distances: torch.Tensor, indices: torch.Tensor,
                        ok_rows: Optional[torch.Tensor], *,
                        select_min: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flag masked query rows in search outputs: id -1 and the metric's
    worst distance (+inf, or -inf when ``select_min`` is False), with no
    host sync."""
    if ok_rows is None:
        return distances, indices
    bad = ~ok_rows[:, None]
    worst = float("inf") if select_min else float("-inf")
    return (torch.where(bad, torch.full_like(distances, worst), distances),
            torch.where(bad, torch.full_like(indices, -1), indices))
