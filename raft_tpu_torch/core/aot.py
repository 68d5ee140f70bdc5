"""Ahead-of-time search programs and the bucket executable cache (port of
``raft_tpu.core.aot``).

The JAX package exports a jitted search as StableHLO and reloads it from a
self-contained artifact; its serving layer warms one loaded executable per
bucket shape.  The port keeps the artifact's container and the cache's key,
and changes what rides in them:

- the artifact is ``_MAGIC``, a u64 length, a program blob, then an ``npz``
  of the baked arrays (bf16 as a uint16 view with a dtype manifest), in the
  JAX package's array order.  The blob is a JSON manifest of the search
  (entry kind, metric, k, n_probes, batch, scan mode, static group
  capacity, filter width, CAGRA's walk knobs), not a compiled program:
  :func:`load_search_fn` rebuilds the search from the manifest over the
  arrays, on the port's own functions and kernels.  A JAX artifact (a
  StableHLO blob) is refused with :class:`AotFormatError`;
- :class:`ExecutableCache` keeps one search per bucket under the JAX key.
  On a CUDA device a miss runs the search once on a side stream, then
  captures it in a CUDA graph (``torch.cuda.graph``) over static input and
  output buffers; the cached callable copies the queries in, replays, and
  returns clones of the outputs.  ``aot.captures`` counts captures: "zero
  new captures after warm-up" is the port's "zero recompiles".  On the CPU
  the callable is the search itself.

The searches here run the port's own scan helpers (``ivf_pq._search_*``,
``ivf_flat_scan``, the CAGRA walk) and wait on nothing: the grouped scans
group at :func:`raft_tpu_torch.neighbors.grouped.group_capacity`'s static
count (:func:`~raft_tpu_torch.neighbors.grouped.groups_of`), and no
validation runs inside (the serving front end checks each request on the
host).  The
IVF-PQ modes are the JAX exporter's: ``fused`` is Kernel B over the baked
recon cache (``aot.py:322``) and ``auto`` serves as ``recon`` (Kernel G),
where ``ivf_pq.search`` resolves ``fused`` to Kernel C on a codes-eligible
index and ``auto`` to Kernel B.  ``export_fn`` / ``load_fn`` serialize
a function made of torch ops through ``torch.export``.

Usage::

    from raft_tpu_torch.core import aot
    buf = aot.export_ivf_pq_search(res, index, n_probes=32, k=10, batch=64)
    g = aot.load_search_fn(buf)               # on the card by default
    d, i = g(queries)                         # (64, dim) float32
"""

from __future__ import annotations

import io
import json
import threading
import types
import weakref
from typing import BinaryIO, Callable, Dict, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import RaftError, expects, not_ported_stub

_MAGIC = b"RAFT_TPU_AOT1"
_FORMAT = "raft_tpu_torch.aot/1"
_ITEM7 = "distributed (item 7)"


class AotFormatError(RaftError, ValueError):
    """The stream is not an artifact the port can run (not an artifact at
    all, or a ``raft_tpu`` JAX artifact whose program is StableHLO)."""


# ---------------------------------------------------------------------------
# torch.export of plain torch functions
# ---------------------------------------------------------------------------

def export_fn(fn: Callable, example_args: Sequence) -> bytes:
    """Serialize ``fn`` (a function of torch ops) traced by
    ``torch.export`` at the example arguments' shapes and dtypes; a
    tuple result comes back as a tuple."""
    class _Fn(torch.nn.Module):
        def forward(self, *args):
            out = fn(*args)
            return tuple(out) if isinstance(out, (tuple, list)) else out

    args = tuple(a if isinstance(a, torch.Tensor) else
                 torch.as_tensor(np.asarray(a)) for a in example_args)
    buf = io.BytesIO()
    torch.export.save(torch.export.export(_Fn(), args), buf)
    return buf.getvalue()


def load_fn(blob: bytes) -> Callable:
    """The callable of an :func:`export_fn` blob."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*args):
        return module(*args)

    return call


# ---------------------------------------------------------------------------
# the artifact container
# ---------------------------------------------------------------------------

def _host(a) -> Tuple[np.ndarray, str]:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return (np.ascontiguousarray(
                a.detach().view(torch.uint16).cpu().numpy()), "bfloat16")
        return np.ascontiguousarray(a.detach().cpu().numpy()), "native"
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, "native"


def save_search_fn(stream: BinaryIO, program: Mapping, arrays: Sequence
                   ) -> None:
    """Write one artifact: ``_MAGIC``, the u64 length of the program blob
    (``program`` as JSON), the blob, then ``np.savez`` of ``arrays`` as
    ``a0 .. aN`` plus their ``dtypes`` manifest — the JAX package's
    container, with the manifest where it keeps StableHLO."""
    blob = json.dumps(dict(program, format=_FORMAT),
                      sort_keys=True).encode()
    stream.write(_MAGIC)
    stream.write(len(blob).to_bytes(8, "little"))
    stream.write(blob)
    metas, store = [], {}
    for i, a in enumerate(arrays):
        store[f"a{i}"], meta = _host(a)
        metas.append(meta)
    store["dtypes"] = np.asarray(metas)
    np.savez(stream, **store)


def read_artifact(stream: BinaryIO) -> Tuple[Dict, list]:
    """``(program, arrays)`` of an artifact, the arrays as numpy (bf16 as
    the uint16 view, named by ``program["dtypes"]``).  A stream without
    ``_MAGIC`` or with a blob that is not the port's manifest (a JAX
    artifact's StableHLO) raises :class:`AotFormatError`."""
    magic = stream.read(len(_MAGIC))
    if magic != _MAGIC:
        raise AotFormatError("aot: not a raft_tpu AOT artifact")
    blob = stream.read(int.from_bytes(stream.read(8), "little"))
    try:
        program = json.loads(blob.decode())
        ok = isinstance(program, dict) and program.get("format") == _FORMAT
    except (UnicodeDecodeError, ValueError):
        ok = False
    if not ok:
        raise AotFormatError(
            "aot: the artifact's program blob is a StableHLO export (a "
            "raft_tpu JAX artifact), which the port cannot run — export "
            "the index with raft_tpu_torch.core.aot instead")
    with np.load(stream, allow_pickle=False) as payload:
        program["dtypes"] = [str(s) for s in payload["dtypes"]]
        arrays = [payload[f"a{i}"] for i in range(len(program["dtypes"]))]
    return program, arrays


def load_search_fn(stream: BinaryIO, device="cuda") -> Callable:
    """Load a :func:`save_search_fn` artifact onto ``device`` (the card
    unless the caller asks for the CPU); returns ``g(queries[, words])``
    -> ``(distances, indices)``."""
    program, host = read_artifact(stream)
    dev = torch.device(device)
    arrays = []
    for a, meta in zip(host, program["dtypes"]):
        t = torch.from_numpy(np.array(a))
        arrays.append((t.view(torch.bfloat16) if meta == "bfloat16"
                       else t).to(dev))
    return search_program(program, arrays)


# ---------------------------------------------------------------------------
# the search programs a manifest names
# ---------------------------------------------------------------------------

def search_program(program: Mapping, arrays: Sequence[torch.Tensor]
                   ) -> Callable:
    """The search ``g(queries[, words]) -> (distances, indices)`` that
    ``program`` (an artifact's manifest) names, over ``arrays`` (its
    tensors, in the artifact's order)."""
    entry = program["entry"]
    if entry == "ivf_pq":
        g = _ivf_pq_program(program, arrays)
    elif entry == "ivf_flat":
        g = _ivf_flat_program(program, arrays)
    elif entry == "brute_force":
        g = _brute_force_program(program, arrays)
    elif entry == "cagra":
        g = _cagra_program(program, arrays)
    else:
        raise AotFormatError(f"aot: unknown program entry {entry!r}")
    shape = (int(program["batch"]), int(program["dim"]))
    nfw = int(program.get("n_filter_words", 0))

    def run(queries, words=None):
        # a program is specialized to its bucket, as an export is
        expects(tuple(queries.shape) == shape,
                f"aot: queries of shape {tuple(queries.shape)} given to a "
                f"program exported at {shape}")
        expects((words is None) == (nfw == 0),
                f"aot: the program takes {nfw} filter words a query")
        return g(queries, words)
    return run


def _ivf_pq_program(p: Mapping, arrays) -> Callable:
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.utils import precision

    metric, k, n_probes = int(p["metric"]), int(p["k"]), int(p["n_probes"])
    mode = p["scan_mode"]
    centers, list_indices, rotation = arrays[0], arrays[3], arrays[4]
    cap = int(list_indices.shape[1])
    kt = min(k, cap)
    if mode in ("recon", "fused"):
        # the recon scans read no more of an index than this
        index = types.SimpleNamespace(
            centers=centers, list_recon=arrays[1], list_recon_sq=arrays[2],
            list_indices=list_indices, metric=metric, capacity=cap,
            rot_dim=int(arrays[1].shape[2]))
        scan = ivf_pq._recon_scan(index, k, kt, mode == "fused")[0]
    else:
        codebooks, list_codes = arrays[1], arrays[2]
        index = ivf_pq.Index(
            centers=centers, codebooks=codebooks, list_codes=list_codes,
            list_indices=list_indices,
            list_sizes=(list_indices != -1).sum(1).to(torch.int32),
            rotation=rotation, list_recon=None, list_recon_sq=None,
            list_code_rsq=None, list_recon_i8=None, list_recon_scale=None,
            list_recon_i8_sq=None, metric=metric,
            codebook_kind=int(p["codebook_kind"]), pq_bits=int(p["pq_bits"]),
            pq_dim_=int(p["pq_dim"]))

        def scan(index, qrot, probes, k, kt, words):
            return ivf_pq._search_lut(index, qrot, probes, k, torch.float32,
                                      words)

    def g(queries, words=None):
        with precision.highest():
            qrot = queries.float() @ rotation
            probes = ivf_pq._select_clusters(centers, qrot, n_probes, metric)
            return scan(index, qrot, probes, k, kt, words)
    return g


def _ivf_flat_program(p: Mapping, arrays) -> Callable:
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops.pair_scan import ivf_flat_scan
    from raft_tpu_torch.utils import precision

    metric, k, n_probes = int(p["metric"]), int(p["k"]), int(p["n_probes"])
    centers, data, ids = arrays
    n_lists, cap, dim = data.shape
    ip = metric == DistanceType.InnerProduct
    dsq = None if ip else ivf_flat._row_norms(data)
    F, n_eff = ivf_flat.super_tile_factor(cap, n_lists, n_probes)
    if F > 1:
        data = data.reshape(n_eff, F * cap, dim)
        ids = ids.reshape(n_eff, F * cap)
        dsq = None if ip else dsq.reshape(n_eff, F * cap)

    def g(queries, words=None):
        with precision.highest():
            qf = queries.float()
            probes = ivf_flat._select_clusters(centers, qf, n_probes, metric)
            if F > 1:
                probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
            vals, found = ivf_flat_scan(qf, probes, data, dsq, ids,
                                        min(k, F * cap), ip, sub_lists=F,
                                        filter_words=words)
            return ivf_flat._finalize_topk(vals, found, k, metric)
    return g


def _brute_force_program(p: Mapping, arrays) -> Callable:
    from raft_tpu_torch import config
    from raft_tpu_torch.core.outputs import raw
    from raft_tpu_torch.filters.bitset import SampleFilter
    from raft_tpu_torch.neighbors import brute_force

    (db,) = arrays
    k, metric = int(p["k"]), int(p["metric"])
    metric_arg = float(p.get("metric_arg", 2.0))
    handle = types.SimpleNamespace(device=db.device)

    def g(queries, words=None):
        f = (None if words is None else
             SampleFilter.from_words(words, words.shape[1] * 32))
        # trusted input: the server validated each request on the host
        with config.validation_policy("off"):
            return raw(brute_force.knn)(handle, db, queries, k,
                                        metric=metric,
                                        metric_arg=metric_arg, filter=f)
    return g


def _cagra_program(p: Mapping, arrays) -> Callable:
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.utils import precision

    quant = bool(p["quant"])
    dataset, table, entry_proj, entry_sq, entry_ids, proj = arrays[:6]
    scales = arrays[6] if quant else None

    def g(queries, words=None):
        with precision.highest():
            return cagra._search_impl_walk(
                dataset, table, entry_proj, entry_sq, entry_ids, proj,
                queries.float(), int(p["k"]), int(p["itopk"]),
                int(p["search_width"]), int(p["max_iterations"]),
                int(p["metric"]), int(p["rerank"]), int(p["graph_degree"]),
                quant=quant, scales=scales, filter_words=words)
    return g


# ---------------------------------------------------------------------------
# exporters: (manifest, arrays) and the artifact
# ---------------------------------------------------------------------------

def _artifact(program: Mapping, arrays: Sequence) -> io.BytesIO:
    buf = io.BytesIO()
    save_search_fn(buf, program, arrays)
    buf.seek(0)
    return buf


def _bake_ivf_pq(res, index, n_probes: int, k: int, batch: int, *,
                 scan_mode: str = "recon", n_filter_words: int = 0):
    from raft_tpu_torch.neighbors import grouped, ivf_pq

    expects(scan_mode in ("recon", "codes", "lut", "fused"),
            "aot: scan_mode must be 'recon', 'codes', 'lut' or 'fused'")
    if scan_mode == "fused" and index.list_recon is None:
        scan_mode = "lut"
    program = {"entry": "ivf_pq", "metric": int(index.metric), "k": int(k),
               "n_probes": int(n_probes), "batch": int(batch),
               "dim": int(index.dim), "scan_mode": scan_mode,
               "n_filter_words": int(n_filter_words),
               "pq_bits": int(index.pq_bits), "pq_dim": int(index.pq_dim),
               "codebook_kind": int(index.codebook_kind),
               "group_capacity": 0}
    if scan_mode in ("recon", "fused"):
        expects(index.list_recon is not None,
                "aot: index must carry the reconstruction cache")
        if index.list_recon_sq is None:
            index.list_recon_sq = ivf_pq._recon_sq(index.list_recon)
        if scan_mode == "fused":
            program["group_capacity"] = grouped.group_capacity(
                batch, n_probes, index.n_lists)[0]
        arrays = (index.centers, index.list_recon, index.list_recon_sq,
                  index.list_indices, index.rotation)
    else:
        arrays = (index.centers, index.codebooks, index.list_codes,
                  index.list_indices, index.rotation)
    return program, arrays


def export_ivf_pq_search(res, index, n_probes: int, k: int, batch: int,
                         *, scan_mode: str = "recon", merge_window=0,
                         n_filter_words: int = 0) -> io.BytesIO:
    """The IVF-PQ search at fixed (batch, k, n_probes) as one artifact
    (``aot.py:257``).  ``scan_mode``: ``"recon"`` bakes the bf16 recon
    cache and its norms (Kernel G, then each query's top k); ``"fused"``
    the same arrays for Kernel B, captured at
    :func:`~raft_tpu_torch.neighbors.grouped.group_capacity`'s static
    count (the manifest's ``group_capacity``; the LUT export without a
    recon cache); ``"codes"`` / ``"lut"`` the packed codes and books for
    the lookup-table scan.  ``merge_window`` is validated as in the JAX
    package; it selects nothing (a staging ring the port does not have),
    so the artifact does not carry it.  ``n_filter_words`` > 0 adds a
    (batch, n_filter_words) int32 admission bitset as the second runtime
    input."""
    from raft_tpu_torch.ops import vmem_budget as vb

    vb.merge_window_request(merge_window)
    return _artifact(*_bake_ivf_pq(res, index, n_probes, k, batch,
                                   scan_mode=scan_mode,
                                   n_filter_words=n_filter_words))


def _bake_ivf_flat(res, index, n_probes: int, k: int, batch: int, *,
                   n_filter_words: int = 0):
    program = {"entry": "ivf_flat", "metric": int(index.metric),
               "k": int(k), "n_probes": int(n_probes), "batch": int(batch),
               "dim": int(index.dim), "n_filter_words": int(n_filter_words)}
    return program, (index.centers, index.list_data, index.list_indices)


def export_ivf_flat_search(res, index, n_probes: int, k: int, batch: int,
                           *, n_filter_words: int = 0) -> io.BytesIO:
    """The IVF-Flat search at fixed (batch, k, n_probes): centers, list
    rows and ids, with Kernel F grouped at the static capacity."""
    return _artifact(*_bake_ivf_flat(res, index, n_probes, k, batch,
                                     n_filter_words=n_filter_words))


def _bake_brute_force(res, database, k: int, batch: int, *, metric=None,
                      metric_arg: float = 2.0, n_filter_words: int = 0):
    from raft_tpu_torch.core.mdarray import ensure_tensor
    from raft_tpu_torch.distance.types import DistanceType

    if metric is None:
        metric = DistanceType.L2Unexpanded
    database = ensure_tensor(database, res, "database")
    program = {"entry": "brute_force", "metric": int(metric), "k": int(k),
               "batch": int(batch), "dim": int(database.shape[1]),
               "metric_arg": float(metric_arg),
               "n_filter_words": int(n_filter_words)}
    # another tensor over the same storage: a cached program must not
    # keep the database object its cache entry is keyed by alive
    return program, (database.detach(),)


def export_brute_force_knn(res, database, k: int, batch: int, *,
                           metric=None, metric_arg: float = 2.0,
                           n_filter_words: int = 0) -> io.BytesIO:
    """Exact kNN over a fixed database at (batch, k): the database rides
    in the artifact, the queries are the runtime input."""
    return _artifact(*_bake_brute_force(
        res, database, k, batch, metric=metric, metric_arg=metric_arg,
        n_filter_words=n_filter_words))


def _bake_cagra(res, index, k: int, batch: int, *, itopk: int = 64,
                search_width: int = 1, max_iterations: int = 0,
                walk_pdim: int = 0, n_filter_words: int = 0):
    from raft_tpu_torch.neighbors import cagra

    itopk = max(itopk, k)
    pdim = walk_pdim or cagra._auto_pdim(index)
    expects(pdim > 0,
            "aot: walk fidelity calibration failed — no packed walk to "
            "export (the live fallback, the exact direct walk, is not "
            "exportable)")
    fmt = cagra._search_table_format(index, pdim)
    expects(fmt is not None,
            "aot: no packed walk table format fits the size gate")
    pdim, quant = fmt
    cache = cagra._walk_cache(res, index, pdim, max(4096, itopk),
                              quant=quant)
    program = {"entry": "cagra", "metric": int(index.metric), "k": int(k),
               "batch": int(batch), "dim": int(index.dim),
               "itopk": int(itopk), "search_width": int(search_width),
               "max_iterations": int(max_iterations or (
                   10 + itopk // max(search_width, 1))),
               "rerank": int(max(min(itopk, max(32, 2 * k)), k)),
               "graph_degree": int(index.graph_degree), "quant": bool(quant),
               "n_filter_words": int(n_filter_words)}
    arrays = (index.dataset, cache.table, cache.entry_proj, cache.entry_sq,
              cache.entry_ids, cache.proj)
    if quant:
        arrays += (cache.scales,)
    return program, arrays


def export_cagra_search(res, index, k: int, batch: int, *, itopk: int = 64,
                        search_width: int = 1, max_iterations: int = 0,
                        walk_pdim: int = 0,
                        n_filter_words: int = 0) -> io.BytesIO:
    """The CAGRA packed-table walk at fixed (batch, k, itopk,
    search_width): dataset, walk table, entry set and projection (and the
    int8 table's scales).  The table is built here as the first live
    search builds it; an index whose calibration rejects every projection
    (the live search's exact direct walk, seeded at random per call) is
    refused, as in the JAX package."""
    return _artifact(*_bake_cagra(
        res, index, k, batch, itopk=itopk, search_width=search_width,
        max_iterations=max_iterations, walk_pdim=walk_pdim,
        n_filter_words=n_filter_words))


export_ivf_pq_routed_search = not_ported_stub(
    "core.aot", "export_ivf_pq_routed_search", _ITEM7)
warm_write_router = not_ported_stub("core.aot", "warm_write_router", _ITEM7)


# ---------------------------------------------------------------------------
# captured CUDA graphs
# ---------------------------------------------------------------------------

class GraphPool:
    """One CUDA graph memory pool, the stream its graphs are captured on
    and the lock their replays hold.  Graphs captured on one stream into
    one pool reuse each other's intermediates (the caching allocator
    reuses a freed block only on its own stream), so they are replayed
    one at a time, on one stream (the dispatcher's).  A dead graph's
    blocks go to the next capture.  An executor gives all its buckets one
    pool."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._handle = None
        self._stream = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def stream(self, device) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def drop_stream(self) -> None:
        self._stream = None

    def bytes(self, device=None) -> Optional[int]:
        """Bytes the allocator holds in this pool's segments (None before
        the first capture, or where the snapshot carries no pool ids)."""
        if self._handle is None:
            return None
        total, seen = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            seen = True
            if tuple(pid) == tuple(self._handle):
                total += int(seg["total_size"])
        return total if seen else None


def _capture(fn: Callable, program: Mapping, dtype: torch.dtype,
             device: torch.device, pool: GraphPool) -> Callable:
    """Warm ``fn`` on a side stream at the bucket's shape, capture it in a
    CUDA graph over static buffers, and return the replaying callable."""
    batch, dim = int(program["batch"]), int(program["dim"])
    nfw = int(program.get("n_filter_words", 0))
    static_q = torch.zeros((batch, dim), dtype=dtype, device=device)
    static_w = (torch.full((batch, nfw), -1, dtype=torch.int32,
                           device=device) if nfw else None)
    args = (static_q,) + ((static_w,) if nfw else ())
    stream = pool.stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    # first use on this stream: the kernel library's build, cuBLAS's
    # workspace, lazily attached caches — none may happen under capture
    with torch.cuda.stream(stream):
        fn(*args)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        # thread_local: another thread replays graphs while this one
        # captures
        with torch.cuda.graph(graph, pool=pool.handle(), stream=stream,
                              capture_error_mode="thread_local"):
            out_d, out_i = fn(*args)
    except BaseException:
        # a refused capture may leave its stream routed to the pool: the
        # pool's next capture takes a new stream
        pool.drop_stream()
        raise
    torch.cuda.current_stream(device).wait_stream(stream)

    def replay(queries, words=None):
        with pool.lock:
            static_q.copy_(torch.as_tensor(queries))
            if nfw:
                static_w.copy_(torch.as_tensor(words))
            graph.replay()
            # the next replay overwrites the static outputs
            return out_d.clone(), out_i.clone()

    # the graph reads the tensors fn closes over (the index's arrays):
    # holding fn keeps them alive as long as the graph
    replay.graph, replay.search = graph, fn
    return replay


# ---------------------------------------------------------------------------
# executable cache — bucket-shaped warm searches for the serving layer
# ---------------------------------------------------------------------------

def _query_dtype(kind: str, index) -> torch.dtype:
    if kind == "brute_force":
        return index.dtype if index.dtype.is_floating_point else \
            torch.float32
    if kind == "cagra":
        return torch.float32
    return index.centers.dtype


class ExecutableCache:
    """Process cache of warm bucket searches, keyed per bucket shape: the
    JAX key ``(kind, id(index), generation, placement generation, batch,
    k, n_probes, scan_mode, rung, export kwargs)``, with ``id(index)``
    validated through a weakref so a recycled id never serves another
    index.  An index's entries go when the index dies, and with them
    their graphs, whose pool blocks the next capture reuses.  A miss
    builds the bucket's program over the index's own tensors (the search
    :func:`load_search_fn` would rebuild from the artifact, without
    copying the index once per bucket) and, on a CUDA device, captures it
    (``captures`` and ``aot.captures``)."""

    def __init__(self) -> None:
        # reentrant: an index can die, and its entries go, while this
        # thread holds the lock
        self._lock = threading.RLock()
        self._entries: Dict[Tuple, Tuple[weakref.ref, Callable]] = {}
        self.hits = 0
        self.misses = 0
        self.captures = 0
        self._default_pool: Optional[GraphPool] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, kind: str, res, index, *, batch: int, k: int,
            n_probes: int = 0, scan_mode: Optional[str] = None,
            rung: int = 0, pool: Optional[GraphPool] = None,
            **export_kwargs) -> Callable:
        """The warm ``g(queries[, words]) -> (distances, indices)`` for one
        bucket, built (and on the card captured) on first use.  ``kind``:
        ``"ivf_pq" | "ivf_flat" | "brute_force" | "cagra"``.  ``rung``
        joins the key but not the program; ``pool`` (not keyed) is the
        :class:`GraphPool` a capture goes into (the cache's own where
        None).  Other keyword arguments go to the exporter and the key."""
        from raft_tpu_torch import observability as obs
        from raft_tpu_torch.observability import flight as _flight

        extra = tuple(sorted(export_kwargs.items()))
        placement_gen = int(getattr(getattr(index, "placement", None),
                                    "generation", 0) or 0)
        key = (kind, id(index), int(getattr(index, "generation", 0) or 0),
               placement_gen, int(batch), int(k), int(n_probes),
               scan_mode, int(rung), extra)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0]() is index:
                self.hits += 1
                if obs.enabled():
                    obs.registry().counter("aot.cache.hits").inc()
                return hit[1]
            self.misses += 1
        if obs.enabled():
            obs.registry().counter("aot.cache.misses").inc()
        # always-on flight event: a miss outside warm-up or a swap puts a
        # capture on the serving path
        _flight.record_event("aot.cache_miss", kind=kind, batch=int(batch),
                             k=int(k), n_probes=int(n_probes),
                             scan_mode=scan_mode)
        g = self._export_load(kind, res, index, batch=batch, k=k,
                              n_probes=n_probes, scan_mode=scan_mode,
                              pool=pool, **export_kwargs)
        with self._lock:
            self._entries[key] = (weakref.ref(index, self._dropper(key)), g)
        return g

    def _dropper(self, key: Tuple) -> Callable:
        """The weakref callback of ``key``'s index: drop its entry, unless
        the key has since been taken by another index at a recycled id."""
        def drop(ref):
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None and hit[0] is ref:
                    del self._entries[key]
        return drop

    def _export_load(self, kind: str, res, index, *, batch: int, k: int,
                     n_probes: int, scan_mode: Optional[str],
                     pool: Optional[GraphPool], **export_kwargs
                     ) -> Callable:
        if kind == "ivf_pq":
            program, arrays = _bake_ivf_pq(
                res, index, n_probes, k, batch,
                scan_mode=scan_mode or "recon", **export_kwargs)
        elif kind == "ivf_flat":
            program, arrays = _bake_ivf_flat(res, index, n_probes, k, batch,
                                             **export_kwargs)
        elif kind == "brute_force":
            program, arrays = _bake_brute_force(res, index, k, batch,
                                                **export_kwargs)
        elif kind == "cagra":
            program, arrays = _bake_cagra(res, index, k, batch,
                                          **export_kwargs)
        elif kind == "ivf_pq_routed":
            return export_ivf_pq_routed_search(res, index)
        else:
            expects(False, f"aot: unknown executable kind {kind!r}")
        g = search_program(program, arrays)
        device = arrays[0].device
        if device.type != "cuda":
            return g
        if pool is None:
            if self._default_pool is None:
                self._default_pool = GraphPool()
            pool = self._default_pool
        g = _capture(g, program, _query_dtype(kind, index), device, pool)
        self._note_capture()
        return g

    def _note_capture(self) -> None:
        """One more captured graph: ``captures`` and, under collection,
        ``aot.captures`` (the port's ``xla.compiles``)."""
        from raft_tpu_torch import observability as obs

        with self._lock:
            self.captures += 1
        if obs.enabled():
            obs.registry().counter("aot.captures").inc()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_EXECUTABLES = ExecutableCache()


def executables() -> ExecutableCache:
    """The process-global executable cache (serving warms into this)."""
    return _EXECUTABLES
