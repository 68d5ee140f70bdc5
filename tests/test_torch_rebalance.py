"""The port's rebalancer (``raft_tpu_torch.serving.rebalancer``) against the
JAX package's, on the CPU.

- Plan parity: on one ``raft_tpu`` index (IVF-Flat with one list crammed
  past the overfull factor, IVF-PQ with tombstones) carried into the port
  through ``serialize``, the port's pass plans the same overfull lists, in
  the same order, and the same dead fraction as the JAX pass; a pass cap
  keeps the same fullest lists.
- A pass re-clusters the overfull list (delete + extend on Kernels A and
  H's plain versions here), compacts, passes the gate (``integrity.verify``
  and the recall canary) and swaps in through ``Server.swap_index``; every
  live id survives.
- The kill matrix: a fault at each stage and checkpoint site, then
  ``resume()``, lands on a gated index (the finished candidate or the
  checkpointed base), never a partial one.
"""

import io

import numpy as np
import pytest
import torch

try:
    from raft_tpu import DeviceResources as JaxResources
    from raft_tpu.neighbors import ivf_flat as jf
    from raft_tpu.neighbors import ivf_pq as jp
    from raft_tpu.serving import rebalancer as jreb
except ImportError:   # a machine with the port only
    JaxResources = jf = jp = jreb = None
from raft_tpu_torch import DeviceResources, integrity, serving
from raft_tpu_torch.integrity import canary
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, mutate
from raft_tpu_torch.resilience.faults import FaultInjected, FaultPlan
from raft_tpu_torch.serving import RebalanceConfig, Rebalancer

CPU = DeviceResources(device="cpu", seed=42)
DIM = 16
TIMEOUT = 30
KILL_SITES = ("rebalance.plan", "rebalance.recluster", "rebalance.compact",
              "rebalance.verify", "rebalance.swap", "checkpoint.save",
              "checkpoint.load")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_jax():
    if jreb is None:
        pytest.skip("needs jax and raft_tpu (the reference package)")


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(21)
    centers = rng.normal(scale=6.0, size=(8, DIM))
    x = centers[rng.integers(0, 8, 900)] + rng.normal(size=(900, DIM))
    x = x.astype(np.float32)
    return x[:860], x[860:876]


def _crammed(mod, res, idx, db, n_extra=300):
    """``idx`` with ``n_extra`` rows extended around its fullest list."""
    full = int(torch.argmax((idx.list_indices >= 0).sum(1)))
    center = idx.centers[full].numpy()
    rng = np.random.default_rng(5)
    extra = (center[None, :] + 0.1 * rng.normal(size=(n_extra, DIM))
             ).astype(np.float32)
    n = db.shape[0]
    return mod.extend(res, idx, extra,
                      np.arange(n, n + n_extra, dtype=np.int64))


@pytest.fixture(scope="module")
def flat_pair(dataset):
    """A ``raft_tpu`` IVF-Flat build with one list crammed (by the port's
    extend), carried across both ways: the same index in each package."""
    _need_jax()
    db, _ = dataset
    jres = JaxResources(seed=0)
    jidx = jf.build(jres, jf.IndexParams(n_lists=8, kmeans_n_iters=5), db)
    buf = io.BytesIO()
    jf.serialize(jres, buf, jidx)
    port = _crammed(ivf_flat, CPU, ivf_flat.deserialize(
        CPU, io.BytesIO(buf.getvalue())), db)
    buf = io.BytesIO()
    ivf_flat.serialize(CPU, buf, port)
    return jf.deserialize(jres, io.BytesIO(buf.getvalue())), port


@pytest.fixture(scope="module")
def pq_pair(dataset):
    _need_jax()
    db, _ = dataset
    jres = JaxResources(seed=0)
    jidx = jp.build(jres, jp.IndexParams(n_lists=8, pq_dim=8,
                                         kmeans_n_iters=4), db)
    jidx = jp.delete(jres, jidx, list(range(0, 300)))
    buf = io.BytesIO()
    jp.serialize(jres, buf, jidx)
    return jidx, ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("factor,cap", [(1.5, 8), (1.2, 1), (3.0, 8)])
def test_the_pass_plans_what_the_jax_pass_plans(flat_pair, pq_pair, kind,
                                                factor, cap):
    jidx, port = flat_pair if kind == "ivf_flat" else pq_pair
    cfg = dict(overfull_factor=factor, max_lists_per_pass=cap)
    jo, jd = jreb.Rebalancer(JaxResources(seed=0), jidx,
                             config=jreb.RebalanceConfig(**cfg))._plan(jidx)
    to, td = Rebalancer(CPU, port, config=RebalanceConfig(**cfg))._plan(
        port)
    np.testing.assert_array_equal(to, np.asarray(jo))
    assert td == jd
    if kind == "ivf_flat" and factor == 1.5:
        assert to.size >= 1


def _gated(index, n_rows):
    integrity.verify(index, level="statistical", res=CPU, n_rows=n_rows)
    if getattr(index, "canaries", None) is not None:
        assert canary.health_check(CPU, index, raise_on_fail=True).ok


def test_a_pass_reclusters_and_swaps_in_gated(flat_pair, dataset):
    _, port = flat_pair
    _, q = dataset
    ex = serving.Executor(CPU, "ivf_flat", port, ks=(5,), max_batch=4,
                          search_params=ivf_flat.SearchParams(n_probes=8))
    live = _live_ids(port)
    with serving.Server(ex, serving.ServerConfig(max_batch=4)) as srv:
        rb = Rebalancer(CPU, port, server=srv,
                        config=RebalanceConfig(overfull_factor=1.5))
        out = rb.run_once()
        st = rb.stats()
        assert st["reclustered_rows"] > 0 and st["swaps"] == 1
        assert ex.index is out
        assert mutate.live_count(out) == mutate.live_count(port)
        _, i = srv.search(q[:4], 5, timeout=TIMEOUT)
        assert (i >= 0).all()
    _gated(out, 1160)
    # extend's nearest-center assignment places each row again: every
    # live id is still there, once
    assert _live_ids(out) == live


def _live_ids(index):
    li = index.list_indices
    ids = li[li >= 0].tolist()
    assert len(ids) == len(set(ids))
    return set(ids)


@pytest.fixture(scope="module")
def canaried(dataset):
    db, _ = dataset
    idx = ivf_flat.build(CPU, ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=5, canary_queries=12, canary_k=5,
        canary_floor=0.3), db)
    return ivf_flat.delete(CPU, idx, list(range(0, 250)))


@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_then_resume_lands_gated(canaried, dataset, tmp_path, site):
    db, q = dataset
    rb = Rebalancer(CPU, canaried, checkpoint=str(tmp_path / "ck"))
    base_gen = mutate.generation(canaried)
    crash = "rebalance.swap" if site == "checkpoint.load" else site
    with FaultPlan(seed=1).at(crash, times=1).active():
        with pytest.raises(FaultInjected):
            rb.run_once()
    if site == "checkpoint.load":
        with FaultPlan(seed=1).at(site, times=1).active():
            out = rb.resume()
    else:
        out = rb.resume()
    assert rb.last_good is out
    assert (mutate.generation(out) == base_gen
            or mutate.dead_fraction(out) == 0.0)
    _gated(out, db.shape[0])
    assert not rb.checkpoint.completed
    _, i = ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=8), out, q,
                           5)
    assert (i >= 0).all()


def test_an_ivf_pq_pass_compacts(pq_pair):
    _, port = pq_pair
    rb = Rebalancer(CPU, port)
    out = rb.run_once()
    assert rb.stats()["swaps"] == 1 and mutate.dead_fraction(out) == 0.0
    integrity.verify(out, level="statistical", res=CPU, n_rows=860)


def test_rebalance_routed_is_an_item_7_stand_in():
    with pytest.raises(NotImplementedError, match="item 7"):
        serving.rebalance_routed(None, None)
