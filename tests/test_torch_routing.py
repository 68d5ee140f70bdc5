"""``raft_tpu_torch.distributed.routing`` against ``raft_tpu.distributed.
routing``, on the host (no ranks): ``tests/test_routing.py``'s unit
classes (``TestRoutingConfig``, ``TestPlanUnit``, ``TestProbeWindow``,
``TestHeatWeightedPlacement``) as scenarios that run through both
packages.  A scenario returns plain values (tables, scores, windows,
``stats()``, the overload evidence, error texts), and the two packages'
must be equal: the policy is host numpy in both, so equal means bit for
bit.  The port's ``observe_probes`` also takes a tensor (the routed
search hands it one): one scenario feeds the port tensors and the JAX
package the same counts as numpy.
"""

import importlib
import types

import numpy as np
import pytest
import torch

NL, SHARDS = 32, 8


def package(root):
    return types.SimpleNamespace(
        ann=importlib.import_module(root + ".distributed.ann"),
        routing=importlib.import_module(root + ".distributed.routing"),
        error=importlib.import_module(root + ".core.error"))


PKGS = {"jax": package("raft_tpu"), "port": package("raft_tpu_torch")}


class StubTracker:
    """Fixed load penalties in, overload evidence recorded out."""

    def __init__(self, n, penalties=None):
        self._pen = list(penalties if penalties is not None else [0.0] * n)
        self.overloads = []

    def load_penalties(self):
        return tuple(self._pen)

    def note_overload(self, shard, load):
        self.overloads.append((int(shard), float(load)))


def _placement(pkg, r=2, seed=11):
    sizes = np.random.default_rng(seed).integers(5, 200, NL)
    return pkg.ann.compute_placement(sizes, SHARDS, replication_factor=r)


def _error(pkg, fn):
    try:
        fn()
    except pkg.error.RaftError as err:
        return f"{type(err).__name__}: {err}"
    return None


def _plan(pol, p, down=()):
    eo, es = pol.plan(p, down=down)
    return (np.asarray(eo), np.asarray(es), pol.choice_summary(),
            pol.stats(), pol.shard_scores())


# ---------------------------------------------------------------------------
# the scenarios: each (pkg) -> plain values


BAD_KNOBS = {"ewma_alpha 0": dict(ewma_alpha=0.0),
             "ewma_alpha 1.5": dict(ewma_alpha=1.5),
             "window_slots 0": dict(window_slots=0),
             "window_decay 0": dict(window_decay=0.0),
             "max_pending 0": dict(max_pending=0),
             "overload_factor 0.5": dict(overload_factor=0.5),
             "hot_bucket_rows -1": dict(hot_bucket_rows=-1)}


def config_defaults(pkg):
    cfg = pkg.routing.RoutingConfig()
    return cfg.validate() is cfg, vars(cfg)


def policy_rejects_empty(pkg):
    return (_error(pkg, lambda: pkg.routing.RoutingPolicy(0)),
            _error(pkg, lambda: pkg.routing.RoutingPolicy(SHARDS).plan(
                _placement(pkg), down=(SHARDS,))),
            _error(pkg, lambda: pkg.routing.RoutingPolicy(4).plan(
                _placement(pkg))))


def r1_plan(pkg):
    p = _placement(pkg, r=1)
    return _plan(pkg.routing.RoutingPolicy(SHARDS), p) + (p.owner,
                                                          p.local_slot)


def r2_plans(pkg):
    """Successive plans at r = 2: the EWMA moves the choices."""
    p = _placement(pkg, r=2)
    pol = pkg.routing.RoutingPolicy(SHARDS)
    return [_plan(pol, p) for _ in range(4)]


def down_shard(pkg):
    p = _placement(pkg, r=2)
    return _plan(pkg.routing.RoutingPolicy(SHARDS), p, down=(3,))


def uncovered_list(pkg):
    p = _placement(pkg, r=2)
    owners, _ = p.rank_tables()
    down = tuple(int(owners[j, 0]) for j in range(2))
    return _plan(pkg.routing.RoutingPolicy(SHARDS), p, down=down)


def hedge_least_loaded(pkg):
    p = _placement(pkg, r=3)
    owners, _ = p.rank_tables()
    s = int(p.owner[0])
    mine = np.nonzero(np.asarray(p.owner) == s)[0]
    pen = [0.0] * SHARDS
    pen[int(owners[1, mine[0]])] = 10.0
    pol = pkg.routing.RoutingPolicy(SHARDS,
                                    tracker=StubTracker(SHARDS, pen))
    return _plan(pol, p, down=(s,)) + (s, mine)


def tracker_penalties(pkg):
    pen = [0.0, 2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    pol = pkg.routing.RoutingPolicy(SHARDS,
                                    tracker=StubTracker(SHARDS, pen))
    return pol.shard_scores(), pol.config.penalty_rows


def overload_evidence(pkg):
    p = _placement(pkg, r=1)
    mine = np.nonzero(np.asarray(p.owner) == int(p.owner[0]))[0]
    hist = np.zeros(NL)
    hist[mine] = 1000.0
    tr = StubTracker(SHARDS)
    pol = pkg.routing.RoutingPolicy(SHARDS, tracker=tr)
    pol.observe_probes(hist)
    refreshed = pol.refresh()
    plans = [_plan(pol, p) for _ in range(8)]
    return refreshed, plans, tr.overloads, pol.expected_probe_load()


def heat_weighted_plan(pkg):
    """A refreshed heat window and list rows weight the plan."""
    p = _placement(pkg, r=2)
    pol = pkg.routing.RoutingPolicy(SHARDS)
    heat = np.random.default_rng(5).integers(0, 50, NL).astype(np.float64)
    pol.observe_probes(heat)
    pol.observe_probes(heat[::-1].copy())
    pol.refresh()
    pol.note_list_rows(np.random.default_rng(6).integers(64, 512, NL))
    return [_plan(pol, p) for _ in range(3)] + [pol.ack_plan(p),
                                                pol.ack_plan(
                                                    p, down=(2,),
                                                    lists=[0, 5, 9])]


def refresh_empty(pkg):
    pol = pkg.routing.RoutingPolicy(4)
    return pol.refresh(), pol.expected_probe_load()


def window_decays(pkg):
    pol = pkg.routing.RoutingPolicy(4, pkg.routing.RoutingConfig(
        window_decay=0.5))
    pol.observe_probes(np.array([10.0, 0.0, 0.0, 0.0]))
    a = pol.refresh()
    pol.observe_probes(np.array([0.0, 10.0, 0.0, 0.0]))
    b = pol.refresh()
    return a, b, pol.expected_probe_load(), pol.stats()


def window_slots_bounded(pkg):
    pol = pkg.routing.RoutingPolicy(2, pkg.routing.RoutingConfig(
        window_slots=2))
    for i in range(5):
        pol.observe_probes(np.ones(2) * (i + 1))
        pol.refresh()
    return pol.stats(), pol.expected_probe_load()


def pending_bounded(pkg):
    pol = pkg.routing.RoutingPolicy(2, pkg.routing.RoutingConfig(
        max_pending=3))
    for i in range(10):
        pol.observe_probes(np.array([1.0, float(i)]))
    return pol.stats(), pol.refresh(), pol.expected_probe_load()


def tensor_histograms(pkg):
    """The routed search's histograms: int32 tensors for the port, the
    same counts as numpy for the JAX package."""
    pol = pkg.routing.RoutingPolicy(4)
    rng = np.random.default_rng(9)
    for _ in range(3):
        h = rng.integers(0, 20, NL).astype(np.int32)
        pol.observe_probes(torch.from_numpy(h) if pkg is PKGS["port"]
                           else h)
    return pol.stats()["pending_batches"], pol.refresh(), \
        pol.expected_probe_load()


def spread_buckets(pkg):
    pol = pkg.routing.RoutingPolicy(4, pkg.routing.RoutingConfig(
        hot_bucket_rows=64))
    return [pol.spread_bucket(b) for b in (0, 1, 64, 65, 512)]


def heat_weighted_lpt(pkg):
    """The rebalancer's recompute: probe rate x rows through LPT."""
    sizes = np.full(16, 100, np.int64)
    p0 = pkg.ann.compute_placement(sizes, SHARDS, replication_factor=2)
    heat = np.full(16, 1.0)
    heat[[0, 8]] = 50.0
    heat /= heat.sum()
    weights = np.maximum((sizes * heat * 16).astype(np.int64), 1)
    p1 = pkg.ann.compute_placement(weights, SHARDS, replication_factor=2,
                                   generation=p0.generation + 1)
    return p0.rank_tables(), p1.rank_tables(), p1.generation, p1.n_local


SCENARIOS = {fn.__name__: fn for fn in (
    config_defaults, policy_rejects_empty, r1_plan, r2_plans, down_shard,
    uncovered_list, hedge_least_loaded, tracker_penalties,
    overload_evidence, heat_weighted_plan, refresh_empty, window_decays,
    window_slots_bounded, pending_bounded, tensor_histograms,
    spread_buckets, heat_weighted_lpt)}


def _assert_equal(got, ref, where="result"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), where
        for key in ref:
            _assert_equal(got[key], ref[key], f"{where}[{key!r}]")
    elif isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref), (
            where)
        for j, (a, b) in enumerate(zip(got, ref)):
            _assert_equal(a, b, f"{where}[{j}]")
    elif isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=where)
        assert np.asarray(got).dtype == np.asarray(ref).dtype, where
    else:
        assert got == ref, where


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_policy_matches_the_jax_package(name):
    """The scenario's tables, scores, windows, ``stats()`` and overload
    evidence are the JAX package's, bit for bit."""
    ref = SCENARIOS[name](PKGS["jax"])
    got = SCENARIOS[name](PKGS["port"])
    _assert_equal(got, ref)


@pytest.mark.parametrize("knob", list(BAD_KNOBS))
def test_bad_knobs_raise_the_jax_errors(knob):
    errors = [_error(pkg, lambda pkg=pkg: pkg.routing.RoutingConfig(
        **BAD_KNOBS[knob]).validate()) for pkg in PKGS.values()]
    assert errors[0] is not None and errors[0] == errors[1]


def test_scenarios_check_what_the_jax_tests_check():
    """The JAX unit tests' assertions hold on the port's results."""
    port = PKGS["port"]
    eo, es, _, _, _, owner, slot = r1_plan(port)
    np.testing.assert_array_equal(eo, owner)
    np.testing.assert_array_equal(es, slot)
    choice = r2_plans(port)[0][2]
    assert choice["per_rank_lists"][1] > 0
    assert sum(choice["per_rank_lists"]) == NL
    eo, _, choice, _, _ = down_shard(port)
    assert 3 not in set(eo.tolist()) and choice["down"] == [3]
    eo, es, _, _, _, s, mine = hedge_least_loaded(port)
    assert all(eo[g] != s for g in mine)
    _, _, overloads, _ = overload_evidence(port)
    assert overloads and overloads[-1][1] > 2.0
    heat = window_decays(port)[2]
    assert heat[1] == pytest.approx(2.0 / 3.0)
    assert heat[0] == pytest.approx(1.0 / 3.0)
    assert window_slots_bounded(port)[0]["window_slots"] == 2
    assert pending_bounded(port)[0]["pending_batches"] == 3
    assert spread_buckets(port) == [True, True, True, False, False]
    (_, _), (owners, _), _, _ = heat_weighted_lpt(port)
    assert owners[0, 0] != owners[0, 8]
