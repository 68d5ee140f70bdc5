"""Bucket-shaped search executors over the existing indexes (port of
``raft_tpu.serving.executor``).

One executor wraps one searchable index (IVF-PQ / IVF-Flat / CAGRA / brute
force) and serves a CLOSED set of (batch, k) shapes — the buckets.
``warmup()`` builds every bucket once at server start; after that, a
dispatch at any bucket shape is a cache hit (zero new captures, the
steady-state contract read off the ``aot.captures`` counter).

Two warm paths:

``"aot"`` (default)
    Each bucket's search comes from :func:`raft_tpu_torch.core.aot.
    executables`: the program an artifact of the index names, over the
    index's tensors, captured on the card as a CUDA graph (the grouped
    scans at their static group capacity, so the capture waits on
    nothing).  Falls back to ``"jit"`` per bucket, with a warning and a
    ``serving.aot_fallback`` flight event, when an exporter or a capture
    refuses (e.g. CAGRA's calibration-dependent direct walk).
``"jit"``
    The live module search functions, warmed by calling each bucket shape
    once.

The delta merge (``attach_delta``) and the padded-row mask run after the
replay, outside the graph: the memtable's device view is a new set of
tensors at each refresh, and a graph would read the old addresses.
Padded rows are flagged through the integrity mask path
(:func:`~raft_tpu_torch.integrity.boundary.mask_search_outputs`): id -1 /
worst distance, exactly like a masked non-finite row.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import aot as _aot
from raft_tpu_torch.core.error import expects, not_ported_stub
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.filters import bitset as _fbits
from raft_tpu_torch.filters.bitset import SampleFilter
from raft_tpu_torch.integrity import boundary as _boundary
from raft_tpu_torch.neighbors import delta as _delta
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.serving.buckets import (bucket_sizes, pad_rows,
                                            valid_rows_mask)

_KINDS = ("ivf_pq", "ivf_flat", "cagra", "brute_force")


class Executor:
    """Warmed bucket-shaped search over one local index.

    ``search_params`` is the algorithm's SearchParams (n_probes etc.) —
    fixed for the executor's lifetime, part of every bucket's shape.
    ``ks`` is the closed set of supported k values.  ``ladder`` is an
    optional sequence of ADDITIONAL SearchParams variants — the degraded
    operating points the brownout controller steps through; rung 0 is
    ``search_params``, rung ``i`` serves ``ladder[i-1]``.  Every (bucket,
    k, rung) is warmed and keyed, so a brownout transition is a dict
    lookup.  The executor's captured graphs share one memory pool
    (:class:`~raft_tpu_torch.core.aot.GraphPool`); the device is
    ``res.device``.
    """

    def __init__(self, res, kind: str, index, *, ks: Sequence[int] = (10,),
                 max_batch: int = 1024, search_params=None,
                 ladder: Sequence = (), warm: str = "aot",
                 filter_rows: int = 0) -> None:
        expects(kind in _KINDS,
                f"serving: unknown executor kind {kind!r} (one of {_KINDS})")
        expects(warm in ("aot", "jit"),
                f"serving: warm mode must be 'aot' or 'jit', got {warm!r}")
        self.res = res
        self.kind = kind
        self.device = torch.device(res.device)
        if kind == "brute_force" and not isinstance(index, torch.Tensor):
            index = torch.as_tensor(np.asarray(index), device=self.device)
        self.index = index
        self.ks = tuple(int(k) for k in ks)
        self.max_batch = int(max_batch)
        self.params = search_params
        self._rung_params: Tuple = (search_params, *ladder)
        self.warm = warm
        # filter_rows > 0: every warm search takes a (bucket, n_words)
        # int32 admission bitset — data, not shape (all-ones = unfiltered)
        self.filter_rows = int(filter_rows)
        self.n_filter_words = (_fbits.n_words_for(self.filter_rows)
                               if self.filter_rows else 0)
        self._ones_words: Dict[int, torch.Tensor] = {}
        self.buckets = bucket_sizes(self.max_batch)
        self._fns: Dict[Tuple[int, int, int], Callable] = {}
        # (bucket, k, rung) of the buckets served by the live search
        # because an export or a capture refused
        self.fallbacks: Dict[Tuple[int, int, int], str] = {}
        self.pool = _aot.GraphPool()
        self._delta = None
        self._warmed = False

    @property
    def n_rungs(self) -> int:
        """Number of degradation-ladder operating points (>= 1)."""
        return len(self._rung_params)

    def set_ladder(self, ladder: Sequence) -> None:
        """Install the degraded-rung SearchParams variants (rungs 1..N),
        before :meth:`warmup` — the rung set is part of the closed
        warmed-shape contract."""
        expects(not self._warmed,
                "serving: set_ladder after warmup would put a capture on "
                "the serving path — declare the ladder before "
                "Server.start()")
        self._rung_params = (self.params, *ladder)

    def attach_delta(self, view: Callable) -> None:
        """Attach the streaming-ingest delta tier: ``view`` is a zero-arg
        callable (``Memtable.device_view``) returning the shape-static
        ``(data, ids, tombs)`` snapshot, merged after every bucket search
        through the ``finalize_topk`` epilogue, tombstones masking main
        hits.  Before :meth:`warmup`."""
        expects(not self._warmed,
                "serving: attach_delta after warmup — attach the ingest "
                "tier before Server.start()")
        self._delta = view

    # ---- geometry -------------------------------------------------------

    @property
    def dim(self) -> int:
        return self._index_dim(self.index)

    def _index_dim(self, index) -> int:
        if self.kind == "brute_force":
            return int(index.shape[1])
        return int(index.dim)

    @property
    def select_min(self) -> bool:
        metric = getattr(self.index, "metric", DistanceType.L2Expanded)
        return metric != DistanceType.InnerProduct

    @property
    def query_dtype(self) -> torch.dtype:
        return _aot._query_dtype(self.kind, self.index)

    @property
    def query_np_dtype(self) -> np.dtype:
        """The numpy dtype the batcher assembles buckets in."""
        return torch.empty(0, dtype=self.query_dtype).numpy().dtype

    # ---- warmup ---------------------------------------------------------

    def warmup(self) -> int:
        """Build (capture) every (bucket, k, rung) once and run it; returns
        the number of warmed executables.  Idempotent."""
        if self._warmed:
            return len(self._fns)
        for b in self.buckets:
            for k in self.ks:
                for r in range(self.n_rungs):
                    zeros = torch.zeros((b, self.dim), dtype=self.query_dtype,
                                        device=self.device)
                    # b-1 valid rows also runs the padded-row mask
                    self.search_bucket(zeros, max(1, b - 1), k, rung=r)
                    if obs.enabled():
                        obs.registry().counter(
                            "serving.warmed_executables").inc()
        self._warmed = True
        return len(self._fns)

    def _obtain(self, bucket: int, k: int, rung: int = 0) -> Callable:
        key = (bucket, k, rung)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        fn = self._build_fn(self.index, bucket, k, rung)
        self._fns[key] = fn
        return fn

    def _build_fn(self, index, bucket: int, k: int, rung: int = 0
                  ) -> Callable:
        """One bucket executable against an EXPLICIT index — what
        :meth:`swap_index` uses to assemble a replacement table without
        touching the published one."""
        params = self._rung_params[rung]
        fn = None
        if self.warm == "aot":
            try:
                fn = self._aot_fn(index, bucket, k, params, rung)
            except Exception as e:  # noqa: BLE001 - exporter/capture refusal
                warnings.warn(
                    f"serving: AOT export or capture failed for {self.kind} "
                    f"bucket ({bucket}, {k}, rung {rung}) — falling back to "
                    f"live search: {e}",
                    stacklevel=2)
                self.fallbacks[(bucket, k, rung)] = repr(e)
                _flight.record_event("serving.aot_fallback", kind=self.kind,
                                     bucket=int(bucket), k=int(k),
                                     rung=int(rung), error=repr(e))
        if fn is None:
            fn = self._live_fn(index, k, params)
        return fn

    def _aot_fn(self, index, bucket: int, k: int, params, rung: int
                ) -> Callable:
        cache = _aot.executables()
        fkw = ({"n_filter_words": self.n_filter_words}
               if self.n_filter_words else {})
        if self.kind == "ivf_pq":
            from raft_tpu_torch.ops import vmem_budget as vb
            n_probes = min(params.n_probes, index.n_lists)
            mode = getattr(params, "scan_mode", "auto")
            if mode not in ("recon", "codes", "lut", "fused"):
                mode = ("recon" if index.list_recon is not None
                        else "lut")
            # validated, not keyed: the window selects nothing here
            vb.merge_window_request(getattr(params, "merge_window", "auto"))
            return cache.get("ivf_pq", self.res, index, batch=bucket,
                             k=k, n_probes=n_probes, scan_mode=mode,
                             rung=rung, pool=self.pool, **fkw)
        if self.kind == "ivf_flat":
            n_probes = min(params.n_probes, index.n_lists)
            return cache.get("ivf_flat", self.res, index, batch=bucket,
                             k=k, n_probes=n_probes, rung=rung,
                             pool=self.pool, **fkw)
        if self.kind == "brute_force":
            return cache.get("brute_force", self.res, index,
                             batch=bucket, k=k, rung=rung, pool=self.pool,
                             **fkw)
        itopk = max(getattr(params, "itopk_size", 64), k)
        width = getattr(params, "search_width", 1)
        return cache.get("cagra", self.res, index, batch=bucket, k=k,
                         rung=rung, pool=self.pool, itopk=itopk,
                         search_width=width, **fkw)

    def _live_fn(self, index, k: int, params) -> Callable:
        # the live entry points under validation policy "off": the server
        # already checked each request at submit, and padded zero rows
        # must not be re-flagged.  The closure pins the index ARGUMENT, so
        # a built table stays on the generation it was built against.
        from raft_tpu_torch import config
        from raft_tpu_torch.core.outputs import raw

        if self.kind == "ivf_pq":
            from raft_tpu_torch.neighbors import ivf_pq as mod
        elif self.kind == "ivf_flat":
            from raft_tpu_torch.neighbors import ivf_flat as mod
        elif self.kind == "cagra":
            from raft_tpu_torch.neighbors import cagra as mod
        else:
            from raft_tpu_torch.neighbors import brute_force as mod
        n_rows = self.filter_rows
        res = self.res

        def live(queries, fw=None):
            f = (SampleFilter.from_words(fw, n_rows)
                 if self.n_filter_words else None)
            with config.validation_policy("off"):
                if self.kind == "brute_force":
                    return raw(mod.knn)(res, index, queries, k, filter=f)
                return raw(mod.search)(res, params, index, queries, k,
                                       filter=f)
        return live

    # ---- generation swap ------------------------------------------------

    def swap_index(self, new_index) -> int:
        """Swap in a new index generation without a serving gap.

        Builds a COMPLETE replacement table against ``new_index`` (on the
        card: one capture a bucket, beside the dispatcher's replays of the
        old table) and, when warmed, runs every bucket once before
        anything is published; the swap itself is one tuple assignment of
        ``(index, _fns)``.  In-flight searches finish on the table they
        started on, and steady-state traffic after the swap captures
        nothing.  Returns the number of bucket executables built."""
        expects(new_index is not None, "serving: swap_index needs an index")
        if self.kind == "brute_force" and not isinstance(new_index,
                                                         torch.Tensor):
            new_index = torch.as_tensor(np.asarray(new_index),
                                        device=self.device)
        dim = self._index_dim(new_index)
        expects(dim == self.dim,
                f"serving: swap_index dim mismatch ({dim} != {self.dim})")
        fns: Dict[Tuple[int, int, int], Callable] = {}
        for b in self.buckets:
            for k in self.ks:
                for r in range(self.n_rungs):
                    fn = self._build_fn(new_index, b, k, r)
                    if self._warmed:
                        zeros = torch.zeros((b, dim), dtype=self.query_dtype,
                                            device=self.device)
                        if self.n_filter_words:
                            fn(zeros, self._all_ones_words(b))
                        else:
                            fn(zeros)
                    fns[(b, k, r)] = fn
        self.index, self._fns = new_index, fns
        if obs.enabled():
            obs.registry().counter("serving.generation_swaps").inc()
        _flight.record_event("serving.generation_swap",
                             generation=getattr(new_index, "generation",
                                                None),
                             executables=len(fns))
        return len(fns)

    # ---- the hot path ---------------------------------------------------

    def _all_ones_words(self, bucket: int) -> torch.Tensor:
        """The cached admit-everything words for ``bucket``."""
        w = self._ones_words.get(bucket)
        if w is None:
            w = torch.full((bucket, self.n_filter_words), -1,
                           dtype=torch.int32, device=self.device)
            self._ones_words[bucket] = w
        return w

    def search_bucket(self, queries, n_valid: int, k: int, rung: int = 0,
                      filter_words=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search a padded bucket batch (a tensor, or numpy, of (bucket,
        dim)); rows past ``n_valid`` come back masked (id -1 / worst
        distance).  ``rung`` selects the degradation-ladder point.
        ``filter_words``: the batch's (bucket, n_filter_words) int32
        admission bitset, on an executor with ``filter_rows > 0`` (None
        there admits everything)."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.ascontiguousarray(queries))
        queries = queries.to(self.device)
        bucket = queries.shape[0]
        expects(0 <= rung < self.n_rungs,
                f"serving: rung {rung} outside the declared ladder "
                f"(n_rungs={self.n_rungs})")
        expects(filter_words is None or self.n_filter_words > 0,
                "serving: executor not configured for filters — "
                "construct with filter_rows=<id bound>")
        # one read of the published table: a concurrent swap_index
        # replaces self._fns wholesale
        fns = self._fns
        fn = fns.get((bucket, k, rung))
        expects(fn is not None or not self._warmed,
                f"serving: shape ({bucket}, {k}, rung {rung}) is not a "
                f"warmed bucket")
        if fn is None:
            fn = self._obtain(bucket, k, rung)
        fw = None
        if self.n_filter_words:
            fw = (torch.as_tensor(filter_words).to(self.device)
                  if filter_words is not None
                  else self._all_ones_words(bucket))
            expects(tuple(fw.shape) == (bucket, self.n_filter_words),
                    f"serving: filter words shape {tuple(fw.shape)} != "
                    f"({bucket}, {self.n_filter_words})")
            d, i = fn(queries, fw)
        else:
            d, i = fn(queries)
        delta = self._delta
        if delta is not None:
            data, ids, tombs = delta()
            d, i = _delta.merge_with_main(
                d, i, queries, data, ids, tombs, k=k,
                metric=getattr(self.index, "metric",
                               DistanceType.L2Expanded),
                filter_words=fw)
        if n_valid < bucket:
            d, i = _boundary.mask_search_outputs(
                d, i, valid_rows_mask(n_valid, bucket, self.device),
                select_min=self.select_min)
        return d, i

    def pad(self, queries, bucket: int):
        return pad_rows(queries, bucket)

    # ---- introspection --------------------------------------------------

    def operating_knobs(self, rung: int = 0) -> Dict[str, object]:
        """The closed-shape coordinates this executor serves ``rung`` at
        (see :class:`raft_tpu_torch.observability.quality.OpPoint`); keys
        absent from the rung's SearchParams come back None."""
        expects(0 <= rung < self.n_rungs,
                f"serving: rung {rung} outside the declared ladder "
                f"(n_rungs={self.n_rungs})")
        params = self._rung_params[rung]
        # a None rung inherits the previous rung's params (the shed-only
        # ladder idiom) — walk back to the operative point
        r = rung
        while params is None and r > 0:
            r -= 1
            params = self._rung_params[r]
        mw = getattr(params, "merge_window", None)
        return {
            "kind": self.kind,
            "bucket": self.max_batch,
            "rung": int(rung),
            "n_probes": getattr(params, "n_probes", None),
            "scan_mode": getattr(params, "scan_mode", None),
            "kt": getattr(params, "per_probe_topk", None),
            "merge_window": mw if isinstance(mw, (int, str,
                                                  type(None))) else str(mw),
            "filtered": bool(self.n_filter_words),
        }


DistributedExecutor = not_ported_stub("serving.executor",
                                      "DistributedExecutor",
                                      "distributed (item 7)")
