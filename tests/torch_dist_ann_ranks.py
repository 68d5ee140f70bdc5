"""The by-row ``distributed.ann`` scenarios that ``test_torch_distributed_
ann.py`` runs through both packages: in gloo CPU ranks of the port
(spawned by ``raft_tpu_torch.comms.launch.spawn``, each holding one shard)
and in the JAX package on its CPU mesh.

A scenario takes the package's modules (:func:`package`), a handle and an
index, and returns plain values (numpy arrays, numbers, strings, dicts),
so the test compares the two packages' results key by key.  This module
imports torch, numpy and the package it is handed: it never imports jax,
and the ranks only ever hand it the port.
"""

import importlib
import types

import numpy as np
import torch

MODES = ("auto", "recon", "fused", "lut", "codes", "recon8")
PROBES = (4, 8)                 # 4 of a shard's 8 lists, and every list
K = 10
PQ_PARAMS = dict(n_lists=8, pq_dim=16, kmeans_n_iters=4)
CANARIES = 16
FLAT_PARAMS = dict(n_lists=8, kmeans_n_iters=4)
CAGRA_PARAMS = dict(intermediate_graph_degree=32, graph_degree=16)
CAGRA_ITOPK = 32
STRAGGLER = dict(shard=1, delay=0.05, jitter=0.01, seed=1)

_MODULES = {"ann": ".distributed.ann", "health": ".distributed.health",
            "ivf_pq": ".neighbors.ivf_pq", "ivf_flat": ".neighbors.ivf_flat",
            "cagra": ".neighbors.cagra", "mutate": ".neighbors.mutate",
            "obs": ".observability", "flight": ".observability.flight",
            "trace": ".observability.trace", "faults": ".resilience.faults",
            "retry": ".resilience.retry", "filters": ".filters",
            "error": ".core.error", "integrity": ".integrity.errors"}


def package(root):
    """The modules a scenario calls, of ``raft_tpu_torch`` or
    ``raft_tpu``."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(root + path)
        for name, path in _MODULES.items()})


def _np(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def _error(pkg, fn):
    """The type and text of the error ``fn()`` raises, or None."""
    try:
        fn()
    except (pkg.error.RaftError, NotImplementedError, TypeError,
            ValueError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def _result(out):
    """A search's outputs as numpy (the stats dict's arrays too)."""
    res = []
    for x in out:
        if isinstance(x, dict):
            x = {key: (_np(v) if hasattr(v, "shape") else v)
                 for key, v in x.items()}
        else:
            x = _np(x)
        res.append(x)
    return tuple(res)


def _counters(pkg):
    snap = pkg.obs.snapshot()["counters"]
    return {key: v for key, v in snap.items()
            if key.split(".")[0] in ("resilience", "distributed", "ivf_pq")}


def search_checks(pkg, h, idx, data, shards):
    """The by-row search contract on an index of ``shards`` shards: every
    scan mode at each probe count, degraded and all-failed searches,
    events and trace, stragglers with a health tracker, a retried fault,
    a spent deadline, a filter, delete."""
    ann, ivf_pq, faults = pkg.ann, pkg.ivf_pq, pkg.faults
    q, k = data["q"], K
    out = {}
    for n_probes in PROBES:
        for mode in MODES:
            sp = ivf_pq.SearchParams(n_probes=n_probes, scan_mode=mode)
            out[f"{mode} {n_probes}"] = _result(ann.search(
                h, sp, idx, q, k, return_status=True, return_stats=True))
    sp = ivf_pq.SearchParams(n_probes=4)
    out["failed_shards"] = _result(ann.search(
        h, sp, idx, q, k, failed_shards=[1], return_status=True,
        return_stats=True))
    with faults.inject() as plan:
        plan.fail_shards(1)
        out["fail_shards"] = _result(ann.search(h, sp, idx, q, k,
                                                return_status=True))
    out["all failed"] = _result(ann.search(
        h, sp, idx, q, k, failed_shards=range(shards), return_status=True))

    # the degraded event and the trace's annotations
    pkg.flight.clear()
    pkg.trace.enable_tracing()
    try:
        rec = pkg.trace.start_request()
        with pkg.trace.activating(rec):
            ann.search(h, sp, idx, q, k, failed_shards=[1])
    finally:
        pkg.trace.disable_tracing()
    evs = pkg.flight.events("distributed.degraded_search")
    out["degraded events"] = [(e["attrs"], e["trace_id"] == rec.trace_id)
                              for e in evs]
    out["trace"] = {key: rec.attrs[key] for key in (
        "distributed.shard_status", "distributed.scan_mode",
        "distributed.n_probes")}

    # stragglers: the delays, the timeout past the shard deadline, the
    # sleeps, and a tracker fed by the search; the FAILED shard then drops
    # out of the next search
    s = STRAGGLER
    slept = []
    sleep, faults._sleep = faults._sleep, slept.append
    tracker = pkg.health.HealthTracker(
        shards, pkg.health.HealthConfig(suspect_after=1, fail_after=1))
    pkg.flight.clear()
    try:
        plan = faults.FaultPlan(seed=s["seed"]).straggle_shard(
            s["shard"], delay=s["delay"], jitter=s["jitter"])
        with plan.active():
            out["straggled"] = _result(ann.search(h, sp, idx, q, k))
            ann.search(h, sp, idx, q, k, shard_deadline_s=0.01,
                       health=tracker)
    finally:
        faults._sleep = sleep
    out["straggler events"] = [e["attrs"] for e in pkg.flight.events(
        "distributed.straggler")]
    out["timeout events"] = [e["attrs"] for e in pkg.flight.events(
        "distributed.shard_timeout")]
    out["slept"] = slept
    out["tracker after straggle"] = tracker.stats()
    out["tracked search"] = _result(ann.search(
        h, sp, idx, q, k, health=tracker, return_status=True))

    # a transient fault at the entry, retried to the same answer
    pkg.obs.reset()
    with pkg.obs.collecting():
        with faults.inject("distributed.ann.search", times=1,
                           exc=faults.TransientFault):
            out["retried"] = _result(ann.search(h, sp, idx, q, k))
    out["retried counters"] = _counters(pkg)
    pkg.obs.reset()
    out["deadline"] = _error(pkg, lambda: ann.search(
        h, sp, idx, q, k, deadline=pkg.retry.Deadline(0.0)))
    try:
        ann.search(h, sp, idx, q, k, deadline=pkg.retry.Deadline(0.0))
    except pkg.retry.DeadlineExceededError as err:
        out["deadline type"] = type(err).__name__

    # a 30% filter over global ids
    out["filtered"] = _result(ann.search(
        h, sp, idx, q, k, filter=pkg.filters.SampleFilter.from_mask(
            data["mask"]), return_stats=True))

    # delete: the doomed ids leave every result, one generation later,
    # and the parent snapshot is untouched
    full = ivf_pq.SearchParams(n_probes=8)
    before = _result(ann.search(h, full, idx, q, k))
    gone = ann.delete(h, idx, data["doomed"])
    out["delete"] = _result(ann.search(h, full, gone, q, k))
    out["generations"] = (pkg.mutate.generation(idx),
                          pkg.mutate.generation(gone))
    out["parent after delete"] = bool(np.array_equal(
        _result(ann.search(h, full, idx, q, k))[1], before[1]))
    out["ground truth params"] = _result(ann.search(
        h, ann.ground_truth_params(idx), idx, q, k, return_stats=True))
    return out


def _reports(reports):
    return None if reports is None else [
        None if r is None else (r.recall, r.floor, r.n_queries, r.k, r.ok)
        for r in reports]


def health_checks(pkg, h, idx, bad, shards):
    """``health_check`` on a sound index and on ``bad`` (shard 1's ids
    scrambled): the reports, the tracker fed by both, the error naming
    the shard."""
    ann = pkg.ann
    tracker = pkg.health.HealthTracker(
        shards, pkg.health.HealthConfig(suspect_after=2, fail_after=1))
    out = {"reports": _reports(ann.health_check(h, idx, health=tracker))}
    pkg.flight.clear()
    out["bad reports"] = _reports(ann.health_check(
        h, bad, raise_on_fail=False, health=tracker))
    out["canary events"] = [e["attrs"] for e in pkg.flight.events(
        "integrity.canary_failure")]
    try:
        ann.health_check(h, bad, health=tracker)
        out["bad error"] = None
    except pkg.integrity.IntegrityError as err:
        out["bad error"] = (str(err), err.invariant, err.coord)
    out["tracker"] = tracker.stats()
    return out


def flat_checks(pkg, h, idx, data):
    ann, sp = pkg.ann, pkg.ivf_flat.SearchParams
    out = {n: _result(ann.search_flat(h, sp(n_probes=n), idx, data["q"], K))
           for n in PROBES}
    out["failed"] = _result(ann.search_flat(
        h, sp(n_probes=4), idx, data["q"], K, failed_shards=[1],
        return_status=True))
    return out


# ---------------------------------------------------------------------------
# the port's ranks


def _load(handle, module, path, n):
    """A rank's shard written by the JAX package (its canaries in the
    stream), as the port's sharded index of ``n`` rows."""
    from raft_tpu_torch.distributed import ann

    with open(path, "rb") as f:
        local = module.deserialize(handle, f)
    cs, local.canaries = local.canaries, None
    return ann._shard_index(handle, local, n, canaries=cs)


def _live_ids(idx):
    ids = idx.local.list_indices
    ids = ids[ids >= 0]
    return int(ids.min()), int(ids.max()), int(ids.numel())


def own_builds(pkg, h, data, shards):
    """The port's own by-row builds: each index's ids at full probe (for
    recall), this rank's id range, and the JAX error texts."""
    ann = pkg.ann
    X, q = data["x"], data["q"]
    out = {}
    pq = ann.build(h, pkg.ivf_pq.IndexParams(**PQ_PARAMS), X)
    out["pq spmd"] = _result(ann.search(
        h, pkg.ivf_pq.SearchParams(n_probes=8), pq, q, K))[1]
    out["pq spmd ids"] = _live_ids(pq)
    pq = ann.build(h, pkg.ivf_pq.IndexParams(canary_queries=CANARIES,
                                             **PQ_PARAMS), X)
    out["pq"] = _result(ann.search(
        h, pkg.ivf_pq.SearchParams(n_probes=8), pq, q, K))[1]
    out["pq ids"] = _live_ids(pq)
    out["pq canaries"] = _reports(ann.health_check(h, pq))
    flat = ann.build_flat(h, pkg.ivf_flat.IndexParams(**FLAT_PARAMS), X)
    out["flat"] = _result(ann.search_flat(
        h, pkg.ivf_flat.SearchParams(n_probes=8), flat, q, K))[1]
    out["flat ids"] = _live_ids(flat)
    params = pkg.ivf_pq.IndexParams(**PQ_PARAMS)
    out["errors"] = {
        "uneven": _error(pkg, lambda: ann.build(h, params, X[:-1])),
        "uneven flat": _error(pkg, lambda: ann.build_flat(
            h, pkg.ivf_flat.IndexParams(**FLAT_PARAMS), X[:-1])),
        "replication": _error(pkg, lambda: ann.build(
            h, params, X, replication_factor=2)),
        "placement": _error(pkg, lambda: ann.build(
            h, params, X, placement="by_grid")),
        "by_list recon": _error(pkg, lambda: ann.build(
            h, pkg.ivf_pq.IndexParams(cache_reconstructions=False,
                                      **PQ_PARAMS), X, placement="by_list")),
        "by_list lists": _error(pkg, lambda: ann.build(
            h, pkg.ivf_pq.IndexParams(**dict(PQ_PARAMS, n_lists=1)), X,
            placement="by_list")),
    }
    # the routed build: one global index on rank 0, its lists placed
    routed = ann.build(h, params, X, placement="by_list")
    out["by_list"] = (type(routed).__name__, routed.n_shards,
                      np.asarray(routed.placement.owner),
                      _result(ann.search(h, pkg.ivf_pq.SearchParams(
                          n_probes=params.n_lists), routed, q, K)))
    return out


def cagra_builds(pkg, h, data):
    """The port's by-row CAGRA: the walk, and the direct walk where the
    table byte gate refuses every table."""
    ann, cagra = pkg.ann, pkg.cagra
    X, q = data["x"], data["q"]
    sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    out = {}
    walk = ann.build_cagra(h, cagra.IndexParams(**CAGRA_PARAMS), X)
    out["walk"] = (walk.use_walk,
                   _result(ann.search_cagra(h, sp, walk, q, K))[1])
    gate = cagra._WALK_TABLE_MAX_BYTES
    cagra._WALK_TABLE_MAX_BYTES = 1
    try:
        direct = ann.build_cagra(h, cagra.IndexParams(**CAGRA_PARAMS), X)
    finally:
        cagra._WALK_TABLE_MAX_BYTES = gate
    out["direct"] = (direct.use_walk,
                     _result(ann.search_cagra(h, sp, direct, q, K))[1])
    return out


def ann_checks(rank, world, data):
    """Everything ``test_torch_distributed_ann.py`` asserts, from one rank:
    at 4 shards (every rank) and at 2 (ranks 0 and 1, a group of their
    own), over the JAX-built shards and the port's own builds."""
    import torch.distributed as dist
    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    pkg = package("raft_tpu_torch")
    pair = dist.new_group([0, 1])
    sessions = {4: CommsSession(device="cpu").init()}
    if rank < 2:
        sessions[2] = CommsSession(group=pair, device="cpu").init()
    runs = {}
    for shards, s in sessions.items():
        h = s.worker_handle(seed=0)
        d = data[shards]
        n = d["x"].shape[0]
        files = d["files"]
        idx = _load(h, ivf_pq, files["pq"][rank], n)
        bad = (_load(h, ivf_pq, files["pq bad"][rank], n)
               if "pq bad" in files else None)
        out = {"search": search_checks(pkg, h, idx, d, shards),
               "flat": flat_checks(pkg, h, _load(
                   h, ivf_flat, files["flat"][rank], n), d),
               "builds": own_builds(pkg, h, d, shards)}
        if shards == 2:
            out["health"] = health_checks(pkg, h, idx, bad, shards)
            out["cagra"] = cagra_builds(pkg, h, d)
        runs[shards] = out
        s.destroy()
    return runs
