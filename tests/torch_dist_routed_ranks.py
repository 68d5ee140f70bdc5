"""The routed ``distributed.ann`` scenarios that ``test_torch_routed.py``
runs through both packages: in gloo CPU ranks of the port (spawned by
``raft_tpu_torch.comms.launch.spawn``, each holding its lists of the
routed index) and in the JAX package on four devices of its CPU mesh.

A scenario takes the package's modules (:func:`package`), a handle and
the routed indexes, and returns plain values, so the test compares the
two packages key by key.  This module imports torch, numpy and the
package it is handed, never jax; the ranks only ever hand it the port.
"""

import importlib
import io
import itertools
import types

import numpy as np
import torch

from torch_dist_ann_ranks import _error, _reports, _result

SHARDS = 4
K = 10
K_WIDE = 100                  # past kt 64: the pair-group routes
NL = 32                       # global lists
PROBES = (8, NL)              # a quarter of the lists, and every list
MODES = ("auto", "recon", "fused", "lut", "codes", "recon8")
FACTORS = (1, 2, 3)
CANARIES = 16
BASE_PARAMS = dict(n_lists=NL, pq_dim=8, kmeans_n_iters=3,
                   cache_reconstructions=True, canary_queries=CANARIES)
HEDGE = dict(shard=2, delay=0.5, deadline=0.05)
SLOW = dict(shard=1, delay=0.04, deadline=0.01)

_MODULES = {"ann": ".distributed.ann", "health": ".distributed.health",
            "routing": ".distributed.routing", "ivf_pq": ".neighbors.ivf_pq",
            "mutate": ".neighbors.mutate", "obs": ".observability",
            "flight": ".observability.flight", "faults": ".resilience.faults",
            "filters": ".filters", "error": ".core.error",
            "integrity": ".integrity.errors"}


def package(root):
    """The modules a scenario calls, of ``raft_tpu_torch`` or
    ``raft_tpu``."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(root + path)
        for name, path in _MODULES.items()})


class StubTracker:
    """A tracker double: fixed load penalties in, overload evidence out."""

    def __init__(self, n, penalties=None):
        self._pen = list(penalties if penalties is not None else [0.0] * n)
        self.overloads = []

    def load_penalties(self):
        return tuple(self._pen)

    def note_overload(self, shard, load):
        self.overloads.append((int(shard), float(load)))


class StubServer:
    """Anything with ``swap_index``, as the JAX tests' readmission uses."""

    def __init__(self):
        self.swapped = []

    def swap_index(self, idx):
        self.swapped.append(idx)


def _events(pkg, name):
    return [e["attrs"] for e in pkg.flight.events(name)]


def _sleeps(pkg):
    """Swap the fault layer's sleep for a recorder; returns (slept,
    restore)."""
    slept = []
    old, pkg.faults._sleep = pkg.faults._sleep, slept.append

    def restore():
        pkg.faults._sleep = old
    return slept, restore


def covered_pair(placement, exclude=()):
    """The first pair of shards (outside ``exclude``) whose loss the
    replicas cover, and the first whose loss strands a list."""
    covered = stranded = None
    for a, b in itertools.combinations(range(SHARDS), 2):
        if a in exclude or b in exclude:
            continue
        eo, _ = placement.healthy_routing((a, b))
        lost = set(np.asarray(eo).tolist()) & {a, b}
        if lost and stranded is None:
            stranded = (a, b)
        if not lost and covered is None:
            covered = (a, b)
    return covered, stranded


def search_checks(pkg, h, idx, data):
    """Every scan mode at each probe count: results, status, stats; the
    tripwire's stats at 8 probes."""
    sp = pkg.ivf_pq.SearchParams
    return {f"{m} {p}": _result(pkg.ann.search(
        h, sp(n_probes=p, scan_mode=m), idx, data["q"], K,
        return_status=True, return_stats=True))
        for p in PROBES for m in MODES}


def failover_checks(pkg, h, idxs, data):
    """r = 2: each single shard failed at full probe (recon and fused);
    r = 3: each pair failed; r = 1 and a stranded pair at r = 2: the
    degraded answers, statuses and events."""
    ann, sp = pkg.ann, pkg.ivf_pq.SearchParams
    q = data["q"]
    out = {}
    for mode in ("recon", "fused"):
        p = sp(n_probes=NL, scan_mode=mode)
        out[f"healthy {mode}"] = _result(ann.search(h, p, idxs[2], q, K))
        for dead in range(SHARDS):
            pkg.flight.clear()
            out[f"r2 dead {dead} {mode}"] = _result(ann.search(
                h, p, idxs[2], q, K, failed_shards=[dead],
                return_status=True))
            out[f"r2 dead {dead} {mode} events"] = (
                _events(pkg, "distributed.replica_failover"),
                _events(pkg, "distributed.degraded_search"))
    p = sp(n_probes=NL)
    out["r3 healthy"] = _result(ann.search(h, p, idxs[3], q, K))
    for a, b in itertools.combinations(range(SHARDS), 2):
        out[f"r3 dead {a} {b}"] = _result(ann.search(
            h, p, idxs[3], q, K, failed_shards=[a, b], return_status=True))
    pkg.flight.clear()
    out["r1 dead 1"] = _result(ann.search(
        h, p, idxs[1], q, K, failed_shards=[1], return_status=True,
        return_stats=True))
    out["r1 dead 1 events"] = _events(pkg, "distributed.degraded_search")
    _, stranded = covered_pair(idxs[2].placement)
    pkg.flight.clear()
    out["r2 stranded"] = (stranded, _result(ann.search(
        h, p, idxs[2], q, K, failed_shards=list(stranded),
        return_status=True)))
    out["r2 stranded events"] = _events(pkg, "distributed.degraded_search")
    return out


def kill_checks(pkg, h, idxs, data):
    """Kills at the route, scan and gather boundaries (r = 2), and at the
    catch-up and swap boundaries during a readmission (r = 3)."""
    ann, faults, health = pkg.ann, pkg.faults, pkg.health
    q, p = data["q"], pkg.ivf_pq.SearchParams(n_probes=NL)
    out = {}
    with faults.FaultPlan(seed=5).kill_shard_at(
            "distributed.route", 3).active():
        out["route"] = _result(ann.search(h, p, idxs[2], q, K,
                                          return_status=True))
    for site in ("distributed.scan", "distributed.gather"):
        with faults.FaultPlan(seed=5).kill_shard_at(site, 1).active():
            out[site] = (_result(ann.search(h, p, idxs[2], q, K,
                                            return_status=True)),
                         _result(ann.search(h, p, idxs[2], q, K,
                                            return_status=True)))
    # r = 3: the readmitted shard 2 and two kills, every list covered
    covered = (0, 1)
    srv = StubServer()
    tr = health.HealthTracker(SHARDS, health.HealthConfig(
        suspect_after=1, fail_after=1, ok_to_clear=1, dwell_s=0.0))
    tr.note_timeout(2)
    tr.note_timeout(2)
    plan = (faults.FaultPlan(seed=5)
            .kill_shard_at("distributed.catch_up", covered[0])
            .kill_shard_at("distributed.swap", covered[1]))
    with plan.active():
        caught = health.catch_up(h, idxs[3], 2, tracker=tr)
        state = tr.state(2)
        ok = health.readmit(h, srv, caught, 2, tracker=tr)
        live = srv.swapped[0]
        out["readmission"] = (covered, state, ok, tr.state(2),
                              live is caught,
                              _result(ann.search(h, p, live, q, K,
                                                 return_status=True)))
    return out


def straggler_checks(pkg, h, idxs, data):
    """A hedged straggler at r = 2 (its wait cut to the shard deadline)
    and one with no replica at r = 1 (waited in full)."""
    ann, faults = pkg.ann, pkg.faults
    q, p = data["q"], pkg.ivf_pq.SearchParams(n_probes=NL)
    out = {}
    slept, restore = _sleeps(pkg)
    try:
        pkg.flight.clear()
        with faults.FaultPlan(seed=3).straggle_shard(
                HEDGE["shard"], delay=HEDGE["delay"]).active():
            out["hedged"] = _result(ann.search(
                h, p, idxs[2], q, K, shard_deadline_s=HEDGE["deadline"],
                return_status=True))
        out["hedged slept"] = list(slept)
        out["hedged events"] = (_events(pkg, "distributed.hedged_read"),
                                _events(pkg, "distributed.shard_timeout"))
        del slept[:]
        with faults.FaultPlan(seed=3).straggle_shard(
                SLOW["shard"], delay=SLOW["delay"]).active():
            out["unhedged"] = _result(ann.search(
                h, p, idxs[1], q, K, shard_deadline_s=SLOW["deadline"]))
        out["unhedged slept"] = list(slept)
    finally:
        restore()
    return out


def policy_checks(pkg, h, idxs, data):
    """``TestRoutedSearchWithPolicy``'s scripts at four shards: a policy
    at full probe (recon and fused), failover and a hedge under a
    policy, a load-SUSPECT shard, the probe histograms."""
    ann, routing, health = pkg.ann, pkg.routing, pkg.health
    q, sp = data["q"], pkg.ivf_pq.SearchParams
    obs = pkg.obs
    out = {}
    p = sp(n_probes=NL)
    pol = routing.RoutingPolicy(SHARDS)
    pkg.flight.clear()
    with obs.collecting():
        c0 = obs.registry().counter("distributed.replica_choice").value
        out["policy"] = _result(ann.search(h, p, idxs[2], q, K,
                                           routing=pol))
        c1 = obs.registry().counter("distributed.replica_choice").value
    # with more than one rank, only rank 0's policy plans
    out["policy choices"] = (c1 - c0, pol.choice_summary().get("down"),
                             _events(pkg, "distributed.replica_choice"))
    out["policy fused"] = _result(ann.search(
        h, sp(n_probes=NL, scan_mode="fused"), idxs[2], q, K,
        routing=routing.RoutingPolicy(SHARDS)))
    pkg.flight.clear()
    out["policy failover"] = _result(ann.search(
        h, p, idxs[2], q, K, failed_shards=(2,),
        routing=routing.RoutingPolicy(SHARDS), return_status=True))
    out["policy failover events"] = _events(pkg, "distributed.replica_choice")
    # a hedge at r = 3 re-issues to the least-loaded covering replica
    r3 = idxs[3]
    owners, _ = r3.placement.rank_tables()
    s = int(r3.placement.owner[0])
    mine = np.nonzero(np.asarray(r3.placement.owner) == s)[0]
    pen_shard = int(owners[1, mine[0]])
    pen = [0.0] * SHARDS
    pen[pen_shard] = 10.0
    pol = routing.RoutingPolicy(SHARDS, tracker=StubTracker(SHARDS, pen))
    slept, restore = _sleeps(pkg)
    pkg.flight.clear()
    try:
        with pkg.faults.FaultPlan(seed=3).straggle_shard(
                s, delay=0.5).active():
            out["policy hedge"] = _result(ann.search(
                h, p, r3, q, K, shard_deadline_s=0.05, routing=pol,
                return_status=True))
    finally:
        restore()
    out["policy hedge plan"] = (s, pen_shard, slept,
                                _events(pkg, "distributed.replica_choice"),
                                len(_events(pkg, "distributed.hedged_read")))
    out["r3 healthy"] = _result(ann.search(h, p, r3, q, K))
    # a shard SUSPECT by load alone is hedged, never counted failed
    tr = health.HealthTracker(SHARDS, health.HealthConfig(suspect_after=2))
    for _ in range(4):
        tr.note_overload(3, 5.0)
    out["load suspect"] = (tr.states(), tr.failed_shards(), _result(
        ann.search(h, p, idxs[2], q, K, health=tr,
                   routing=routing.RoutingPolicy(SHARDS, tracker=tr),
                   return_status=True)))
    # the probe histograms reach the policy, read only at refresh
    pol = routing.RoutingPolicy(SHARDS)
    for _ in range(3):
        ann.search(h, sp(n_probes=4), idxs[2], q, K, routing=pol)
    pending = pol.stats()["pending_batches"]
    out["observed"] = (pending, pol.refresh(), pol.expected_probe_load())
    return out


def mutation_checks(pkg, h, idxs, data):
    """delete, rebalance_placement, route_vectors and a 30% filter at
    r = 2."""
    ann, mutate = pkg.ann, pkg.mutate
    q, idx = data["q"], idxs[2]
    full = pkg.ivf_pq.SearchParams(n_probes=NL)
    out = {}
    before = _result(ann.search(h, full, idx, q, K))
    gone = ann.delete(h, idx, data["doomed"])
    out["delete"] = _result(ann.search(h, full, gone, q, K))
    out["delete generations"] = (mutate.generation(idx),
                                 mutate.generation(gone))
    out["parent after delete"] = bool(np.array_equal(
        _result(ann.search(h, full, idx, q, K))[1], before[1]))
    reb = ann.rebalance_placement(h, idx)
    out["rebalance"] = (reb.placement.generation - idx.placement.generation,
                        mutate.generation(reb) - mutate.generation(idx),
                        np.asarray(reb.placement.owner),
                        _result(ann.search(h, full, reb, q, K)))
    out["route_vectors"] = np.asarray(ann.route_vectors(idx, data["x"][:64]))
    out["filtered"] = _result(ann.search(
        h, pkg.ivf_pq.SearchParams(n_probes=8), idx, q, K,
        filter=pkg.filters.SampleFilter.from_mask(data["mask"]),
        return_stats=True))
    out["ground truth params"] = _result(ann.search(
        h, ann.ground_truth_params(idx), idx, q, K, return_stats=True))
    return out


def health_checks(pkg, h, idx, bad):
    """``health_check`` on a sound routed index and on ``bad`` (a list's
    ids scrambled), with a tracker; the blame; a deleted index measured
    over every rank's tombstones."""
    ann, health = pkg.ann, pkg.health
    tr = health.HealthTracker(SHARDS, health.HealthConfig(
        suspect_after=2, fail_after=1))
    tr.note_timeout(1)        # a suspect to blame
    out = {"reports": _reports(ann.health_check(h, idx, health=tr))}
    pkg.flight.clear()
    out["bad reports"] = _reports(ann.health_check(
        h, bad, raise_on_fail=False, health=tr))
    out["canary events"] = _events(pkg, "integrity.canary_failure")
    try:
        ann.health_check(h, bad, health=tr)
        out["bad error"] = None
    except pkg.integrity.IntegrityError as err:
        out["bad error"] = (str(err), err.invariant)
    out["tracker"] = tr.stats()
    cs = idx.canaries
    doomed = np.unique(np.asarray(cs.gt_ids)[:, 0])[:8].astype(np.int32)
    out["deleted reports"] = _reports(ann.health_check(
        h, ann.delete(h, idx, doomed)))
    return out


def readmit_checks(pkg, h, idxs, data, bad):
    """catch_up + readmit of shard 2 through a stub server, and a blocked
    readmission of a scrambled index."""
    ann, health = pkg.ann, pkg.health
    q, p = data["q"], pkg.ivf_pq.SearchParams(n_probes=NL)
    tr = health.HealthTracker(SHARDS, health.HealthConfig(
        suspect_after=1, fail_after=1, ok_to_clear=1))
    tr.note_timeout(2)
    tr.note_timeout(2)
    pkg.flight.clear()
    caught = health.catch_up(h, idxs[2], 2, tracker=tr, stale=idxs[2])
    srv = StubServer()
    ok = health.readmit(h, srv, caught, 2, tracker=tr)
    out = {"readmit": (ok, tr.state(2), len(srv.swapped),
                       caught.placement.generation
                       - idxs[2].placement.generation,
                       pkg.mutate.generation(caught)
                       - pkg.mutate.generation(idxs[2]),
                       _events(pkg, "distributed.health.catch_up"),
                       _result(ann.search(h, p, caught, q, K)))}
    tr.note_timeout(1)
    tr.note_timeout(1)
    caught = health.catch_up(h, bad, 1, tracker=tr)
    srv = StubServer()
    out["blocked"] = (health.readmit(h, srv, caught, 1, tracker=tr),
                      tr.state(1), len(srv.swapped))
    return out


def scenarios(pkg, h, idxs, data, bad):
    """Everything both packages run."""
    out = {r: search_checks(pkg, h, idxs[r], data) for r in FACTORS}
    out.update(failover=failover_checks(pkg, h, idxs, data),
               kills=kill_checks(pkg, h, idxs, data),
               stragglers=straggler_checks(pkg, h, idxs, data),
               policy=policy_checks(pkg, h, idxs, data),
               mutation=mutation_checks(pkg, h, idxs, data),
               health=health_checks(pkg, h, idxs[2], bad),
               readmit=readmit_checks(pkg, h, idxs, data, bad))
    return out


# ---------------------------------------------------------------------------
# the port's ranks


def _read(h, path):
    from raft_tpu_torch.distributed import ann
    with open(path, "rb") as f:
        return ann.deserialize_routed(h, f)


def _bytes(h, idx):
    from raft_tpu_torch.distributed import ann
    buf = io.BytesIO()
    ann.serialize_routed(h, buf, idx)
    return buf.getvalue()


def _single_forms(pkg, h, base, data):
    """The port's single-index searches of the base at each routed form:
    Kernel C (``fused``), B (``auto``), G (``recon``)."""
    sp = pkg.ivf_pq.SearchParams
    q = torch.from_numpy(data["q"])
    forms = (("fused_codes", "fused"), ("fused_recon", "auto"),
             ("recon", "recon"), ("grouped_recon", "recon"))
    out = {f"{form} {p}": _result(pkg.ivf_pq.search(
        h, sp(n_probes=p, scan_mode=mode), base, q, K))
        for p in PROBES for form, mode in forms}
    out.update({f"{form} k100": _result(pkg.ivf_pq.search(
        h, sp(n_probes=PROBES[0], scan_mode=mode), base, q, K_WIDE))
        for form, mode in forms[::2]})
    return out


def suspect_cases(placement):
    """{case: (failed shard, suspect shard, the rank that alone sees the
    suspect)}: ``stranded`` a pair whose loss strands a list the suspect
    serves, so rank 0's hedge of it is withdrawn and it plans twice;
    ``covered`` a pair the replicas cover, the suspect on rank 1."""
    covered, stranded = covered_pair(placement)
    eo, _ = placement.healthy_routing(stranded)
    s = min(set(np.asarray(eo).tolist()) & set(stranded))
    f = stranded[0] if s == stranded[1] else stranded[1]
    return {"stranded": (f, s, 0), "covered": (covered[0], covered[1], 1)}


def _one_rank_suspect(pkg, h, idx, data):
    """A real tracker shared by a policy and ``health=``, a failed shard,
    and a shard SUSPECT (by overload) in one rank's tracker alone: the
    case's shards, the answer, status, stats, events and this rank's
    tracker states."""
    out = {}
    for case, (f, s, who) in suspect_cases(idx.placement).items():
        tr = pkg.health.HealthTracker(
            SHARDS, pkg.health.HealthConfig(suspect_after=2))
        if h.get_comms().get_rank() == who:
            for _ in range(4):
                tr.note_overload(s, 5.0)
        pkg.flight.clear()
        got = _result(pkg.ann.search(
            h, pkg.ivf_pq.SearchParams(n_probes=NL), idx, data["q"], K,
            failed_shards=(f,), health=tr,
            routing=pkg.routing.RoutingPolicy(SHARDS, tracker=tr),
            return_status=True, return_stats=True))
        out[case] = ((f, s, who), got, {name: _events(pkg, f"distributed.{name}")
                           for name in ("replica_choice", "hedged_read",
                                        "replica_failover")},
                     tr.states())
    return out


def _port_only(pkg, h, base, idxs, data, files):
    """The checks only the port runs: its own shard_by_list of the base,
    byte-equal re-serialization, the legacy streams, the probe sets,
    a skewed rank's policy, ``catch_up(ingest=)``."""
    ann = pkg.ann
    rank = h.get_comms().get_rank()
    out = {"singles": _single_forms(pkg, h, base, data)}
    own = {r: ann.shard_by_list(h, base, replication_factor=r)
           for r in FACTORS}
    out["own placements"] = {
        r: (np.asarray(own[r].placement.owner),
            np.asarray(own[r].placement.local_slot),
            None if own[r].placement.owners is None else
            np.asarray(own[r].placement.owners), own[r].placement.n_local,
            own[r].pq_bits, own[r].local.list_codes is not None)
        for r in FACTORS}
    out["capacity"] = idxs[1].capacity
    out.update({f"k100 {m}": _result(ann.search(
        h, pkg.ivf_pq.SearchParams(n_probes=PROBES[0], scan_mode=m),
        idxs[2], data["q"], K_WIDE, return_stats=True))
        for m in ("fused", "recon")})
    out["own search"] = {(r, m): _result(ann.search(
        h, pkg.ivf_pq.SearchParams(n_probes=PROBES[0], scan_mode=m),
        own[r], data["q"], K, return_status=True, return_stats=True))
        for r in FACTORS for m in ("auto", "recon")}
    out["rewritten"] = {name: _bytes(h, _read(h, path))
                        for name, path in files.items()}
    legacy = {v: _read(h, files[f"v{v}"]) for v in (1, 2)}
    out["legacy"] = {v: (ix.pq_bits, ix.local.list_codes is None,
                         _result(ann.search(
                             h, pkg.ivf_pq.SearchParams(n_probes=PROBES[0]),
                             ix, data["q"], K, return_stats=True)))
                     for v, ix in legacy.items()}
    # the probe set every rank ranks from the replicated leaves
    _, probes = ann._routed_probes(idxs[2], torch.from_numpy(data["q"]),
                                   PROBES[0])
    out["probes"] = probes.numpy()
    # one rank's telemetry skewed: rank 0 alone plans, and every rank
    # routes by its broadcast route
    pol = pkg.routing.RoutingPolicy(
        SHARDS, tracker=StubTracker(SHARDS, [0.0, 0.0, 0.0, 50.0]
                                    if rank == 1 else None))
    pkg.flight.clear()
    with pkg.obs.collecting():
        if rank == 1:
            pkg.obs.registry().gauge("serving.queue_depth").set(1e6)
        res = []
        for _ in range(2):
            res.append(_result(ann.search(
                h, pkg.ivf_pq.SearchParams(n_probes=NL), idxs[2],
                data["q"], K, routing=pol, return_stats=True)))
        pkg.obs.registry().gauge("serving.queue_depth").set(0.0)
    out["skewed"] = (res, _events(pkg, "distributed.replica_choice"),
                     pol.choice_summary().get("per_shard_lists"))
    out["suspect on one rank"] = _one_rank_suspect(pkg, h, idxs[2], data)
    out["ingest"] = _error(pkg, lambda: pkg.health.catch_up(
        h, idxs[2], 0, ingest=object()))
    return out


def routed_checks(rank, world, files):
    """Every check ``test_torch_routed.py`` asserts, from one rank: the
    routed indexes read from the JAX package's streams at r = 1, 2, 3,
    the scrambled index, and the base through the single-index
    stream."""
    import torch.distributed as dist
    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.neighbors import ivf_pq

    pkg = package("raft_tpu_torch")
    pair = dist.new_group([0, 1])
    session = CommsSession(device="cpu").init()
    h = session.worker_handle(seed=0)
    data = files["data"]
    idxs = {r: _read(h, files[f"r{r}"]) for r in FACTORS}
    bad = _read(h, files["bad"])
    with open(files["base"], "rb") as f:
        base = ivf_pq.deserialize(h, f)
    out = scenarios(pkg, h, idxs, data, bad)
    out["port"] = _port_only(pkg, h, base, idxs, data, {
        name: files[name] for name in ("r1", "r2", "r3", "v1", "v2")})
    if rank < 2:
        # a placement of four shards read by a group of two
        two = CommsSession(group=pair, device="cpu").init()
        out["port"]["n_shards"] = _error(pkg, lambda: _read(
            two.worker_handle(seed=0), files["r2"]))
        two.destroy()
    session.destroy()
    return out
