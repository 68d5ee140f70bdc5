"""raft_tpu_torch.integrity.canary — recall canaries — on the CPU, against
the JAX package.

The cases follow the JAX package's ``tests/test_integrity.py`` canary
section (stored at build, carried through the serialize round trip,
health-checked after ``load`` and ``extend``, a damaged index caught by
the check and by ``load``'s automatic check) on port-built indexes, plus
the parity with ``raft_tpu.integrity.canary``: the same sentinel rows and
exact ground truth from the same data, the same nested envelope byte for
byte, and a canary block written by either package read by the other.
The counters the JAX tests read (``integrity.canary.*``, the
``integrity.health_check`` stage and the ``integrity.canary_failure``
flight event) are held to the JAX package's on the same script in
``test_canary_counters_and_events_match_the_reference``.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.integrity import canary as jax_canary
from raft_tpu.neighbors import ivf_flat as jax_ivf_flat
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.integrity import IntegrityError
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

SEED = 20260805


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (a parallel run oversubscribes
    the cores otherwise); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, d, seed=0):
    rng = np.random.default_rng(SEED + seed)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def ires():
    return DeviceResources(seed=7, device="cpu")


@pytest.fixture(scope="module")
def flat_index(ires):
    params = ivf_flat.IndexParams(n_lists=8, canary_queries=16, canary_k=5,
                                  canary_floor=0.3)
    return ivf_flat.build(ires, params, _data(400, 16))


@pytest.fixture(scope="module")
def pq_index(ires):
    params = ivf_pq.IndexParams(n_lists=8, pq_dim=4, canary_queries=16,
                                canary_k=5, canary_floor=0.2)
    return ivf_pq.build(ires, params, _data(400, 16, seed=1))


@pytest.fixture(scope="module")
def cagra_index(ires):
    params = cagra.IndexParams(graph_degree=16, intermediate_graph_degree=32,
                               canary_queries=16, canary_k=5,
                               canary_floor=0.3)
    return cagra.build(ires, params, _data(300, 16, seed=2))


def _zeroed(index):
    """The index with its stored vectors zeroed: the sentinels no longer
    find their true neighbors."""
    return dataclasses.replace(index,
                               list_data=torch.zeros_like(index.list_data),
                               list_data_sq=None)


def test_canaries_recorded_at_build(flat_index, pq_index, cagra_index):
    for index in (flat_index, pq_index, cagra_index):
        cs = index.canaries
        assert cs is not None
        assert cs.queries.shape[0] == 16
        assert cs.gt_ids.shape == (16, 5)
        assert cs.queries.dtype == np.float32 and cs.gt_ids.dtype == np.int32
        assert cs.build_recall >= cs.floor


def test_canaries_survive_serialize_roundtrip(ires, flat_index, pq_index,
                                              cagra_index):
    for mod, index in ((ivf_flat, flat_index), (ivf_pq, pq_index),
                       (cagra, cagra_index)):
        buf = io.BytesIO()
        mod.serialize(ires, buf, index)
        buf.seek(0)
        out = mod.deserialize(ires, buf)
        assert out.canaries is not None
        np.testing.assert_array_equal(out.canaries.gt_ids,
                                      index.canaries.gt_ids)
        np.testing.assert_array_equal(out.canaries.queries,
                                      index.canaries.queries)
        assert out.canaries.floor == index.canaries.floor
        assert out.canaries.build_recall == index.canaries.build_recall


def test_no_canary_roundtrip(ires):
    index = ivf_flat.build(ires, ivf_flat.IndexParams(n_lists=4),
                           _data(64, 8, seed=4))
    buf = io.BytesIO()
    ivf_flat.serialize(ires, buf, index)
    buf.seek(0)
    assert ivf_flat.deserialize(ires, buf).canaries is None
    assert _canary.health_check(ires, index) is None
    assert _canary.floor_of(index) is None
    _canary.auto_check(ires, index, site="load")     # a no-op


def test_health_check_passes_on_healthy(ires, flat_index, pq_index,
                                        cagra_index):
    for index in (flat_index, pq_index, cagra_index):
        report = _canary.health_check(ires, index)
        assert report.ok
        assert report.recall >= index.canaries.floor
        assert (report.n_queries, report.k) == (16, 5)
        assert _canary.floor_of(index) == index.canaries.floor


def test_health_check_detects_regression_after_load(ires, flat_index,
                                                    tmp_path):
    path = str(tmp_path / "flat.idx")
    ivf_flat.save(ires, path, flat_index)
    loaded = ivf_flat.load(ires, path)          # the auto check passes
    assert loaded.canaries is not None
    bad = _zeroed(loaded)
    assert bad.canaries is not None             # dataclasses.replace carries
    with pytest.raises(IntegrityError) as ei:
        _canary.health_check(ires, bad)
    assert ei.value.invariant == "canary.recall_floor"
    report = _canary.health_check(ires, bad, raise_on_fail=False)
    assert not report.ok


@pytest.mark.parametrize("kind", ["ivf_flat", "cagra"])
def test_load_auto_check_raises_on_a_damaged_index(ires, flat_index,
                                                   cagra_index, tmp_path,
                                                   kind):
    """An index saved damaged (its vectors zeroed) carries its canaries
    into the file, and ``load`` refuses it."""
    if kind == "ivf_flat":
        mod, bad = ivf_flat, _zeroed(flat_index)
    else:
        mod = cagra
        bad = cagra.Index(dataset=torch.zeros_like(cagra_index.dataset),
                          graph=cagra_index.graph)
        bad.canaries = cagra_index.canaries
    path = str(tmp_path / "corrupt.idx")
    mod.save(ires, path, bad)
    with pytest.raises(IntegrityError) as ei:
        mod.load(ires, path)
    assert ei.value.invariant == "canary.recall_floor"


def test_extend_carries_and_checks_canaries(ires, flat_index, pq_index):
    new = _data(40, 16, seed=5)
    ids = torch.arange(400, 440, dtype=torch.int32)
    for mod, index in ((ivf_flat, flat_index), (ivf_pq, pq_index)):
        out = mod.extend(ires, index, new, ids)
        assert out.canaries is index.canaries
        assert _canary.health_check(ires, out).ok


def test_extend_of_a_damaged_index_raises(ires, flat_index):
    with pytest.raises(IntegrityError):
        ivf_flat.extend(ires, _zeroed(flat_index), _data(4, 16, seed=6),
                        torch.arange(400, 404, dtype=torch.int32))


def test_measure_leaves_out_tombstoned_ids(ires, flat_index):
    """Ids tombstoned in ``list_indices`` (``-(id + 2)``, as a file the JAX
    package wrote after a delete holds) leave the ground truth and the
    denominator: at full probe the search is exact, so recall stays 1.0
    although the dead id is no longer found."""
    cs = flat_index.canaries
    assert _canary.measure(ires, flat_index, cs) == 1.0
    dead = int(cs.gt_ids[0, 0])
    li = flat_index.list_indices.clone()
    li[li == dead] = -(dead + 2)
    gone = dataclasses.replace(flat_index, list_indices=li)
    assert _canary._deleted_ids(gone) == {dead}
    assert dead not in _canary._search_canaries(ires, gone, cs)
    assert _canary.measure(ires, gone, cs) == 1.0
    assert _canary._deleted_ids(flat_index) == frozenset()


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct])
def test_make_matches_the_reference(metric):
    """The same strided sentinel rows and the same exact ground truth as
    ``raft_tpu.integrity.canary.make`` on the same data."""
    x = _data(500, 16, seed=8)
    ours = _canary.make(DeviceResources(device="cpu"), x, metric=metric,
                        n_queries=12, k=7, floor=0.4)
    ref = jax_canary.make(JaxResources(seed=0), x, metric=metric,
                          n_queries=12, k=7, floor=0.4)
    np.testing.assert_array_equal(ours.queries, np.asarray(ref.queries))
    np.testing.assert_array_equal(ours.gt_ids, np.asarray(ref.gt_ids))
    assert (ours.floor, ours.build_recall) == (ref.floor, ref.build_recall)


def test_canary_block_is_byte_equal_and_reads_across(flat_index):
    """The nested envelope (present flag, floor, build recall, queries,
    ground truth) is the JAX package's byte for byte, and each package
    reads the other's block."""
    cs = flat_index.canaries
    ref_cs = jax_canary.CanarySet(queries=cs.queries, gt_ids=cs.gt_ids,
                                  floor=cs.floor,
                                  build_recall=cs.build_recall)
    ours, ref = io.BytesIO(), io.BytesIO()
    _canary.to_stream(None, ours, cs)
    jax_canary.to_stream(None, ref, ref_cs)
    assert ours.getvalue() == ref.getvalue()
    for reader, raw in ((_canary.from_stream, ref.getvalue()),
                        (jax_canary.from_stream, ours.getvalue())):
        back = reader(None, io.BytesIO(raw))
        np.testing.assert_array_equal(back.gt_ids, cs.gt_ids)
        assert back.build_recall == cs.build_recall
    none = io.BytesIO()
    _canary.to_stream(None, none, None)
    none.seek(0)
    assert _canary.from_stream(None, none) is None


def test_a_raft_tpu_index_with_canaries_loads_and_checks(tmp_path):
    """A ``raft_tpu``-built IVF-Flat index with canaries, saved by the JAX
    package, loads in the port: its canaries read back and the automatic
    check passes on the port's search."""
    x = _data(400, 16, seed=9)
    jidx = jax_ivf_flat.build(JaxResources(seed=7), jax_ivf_flat.IndexParams(
        n_lists=8, canary_queries=16, canary_k=5, canary_floor=0.3), x)
    path = str(tmp_path / "jax.idx")
    jax_ivf_flat.save(JaxResources(seed=7), path, jidx)
    loaded = ivf_flat.load(DeviceResources(device="cpu"), path)
    np.testing.assert_array_equal(loaded.canaries.gt_ids,
                                  np.asarray(jidx.canaries.gt_ids))
    report = _canary.health_check(DeviceResources(device="cpu"), loaded)
    assert report.ok and report.recall == pytest.approx(
        jidx.canaries.build_recall, abs=1 / (16 * 5))


def test_unsupported_index_type_raises():
    cs = _canary.CanarySet(queries=np.zeros((1, 2), np.float32),
                           gt_ids=np.zeros((1, 1), np.int32), floor=0.5)
    with pytest.raises(TypeError, match="unsupported index type"):
        _canary.measure(None, object(), cs)


def test_canary_counters_and_events_match_the_reference(tmp_path):
    """The same script in both packages under collection — a build with
    canaries, save and load (the ``load`` check), ``extend`` (its check), a
    passing health check, then a damaged index's failing one — leaves the
    same ``integrity.*`` counters, the same ``integrity.health_check``
    stage count and the same failure events (recall apart)."""
    import jax.numpy as jnp

    import raft_tpu.observability as jobs
    import raft_tpu_torch.observability as tobs
    from raft_tpu.integrity import canary as jcanary

    x = _data(400, 16, seed=3)
    out = []
    for obs, mod, canary, res, arr, zeros in (
            (jobs, jax_ivf_flat, jcanary, JaxResources(seed=7),
             x, jnp.zeros_like),
            (tobs, ivf_flat, _canary, DeviceResources(seed=7, device="cpu"),
             torch.tensor(x), torch.zeros_like)):
        obs.reset()
        obs.flight.clear()
        with obs.collecting():
            index = mod.build(res, mod.IndexParams(
                n_lists=8, canary_queries=16, canary_k=5, canary_floor=0.3),
                arr)
            path = str(tmp_path / f"{obs.__name__}.idx")
            mod.save(res, path, index)
            index = mod.load(res, path)
            index = mod.extend(res, index, arr[:10])
            assert canary.health_check(res, index).ok
            bad = dataclasses.replace(index,
                                      list_data=zeros(index.list_data),
                                      list_data_sq=None)
            with pytest.raises(Exception) as err:
                canary.health_check(res, bad)
            assert err.value.invariant == "canary.recall_floor"
        snap = obs.snapshot()
        stage = next(t for n, t in snap["timers"].items()
                     if n.endswith("health_check"))
        events = obs.flight.events()
        out.append(({n: v for n, v in snap["counters"].items()
                     if n.startswith("integrity.canary")},
                    stage["count"],
                    [(e["name"], sorted(e["attrs"])) for e in events],
                    [e["attrs"]["floor"] for e in events]))
        obs.flight.clear()
        obs.reset()
    assert out[0] == out[1]
    assert out[1][1] >= 4 and len(out[1][2]) == 1
