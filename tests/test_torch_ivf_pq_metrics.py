"""IVF-PQ search at the metrics the JAX package scores as L2 —
CosineExpanded (2), L1 (3) and CorrelationExpanded (10) — against the
JAX package, on the CPU.

Two indexes a metric, over 3,000 x 40 standard-normal rows (seed 0),
``n_lists=12``, ``pq_dim=10``, ``kmeans_n_iters=4``: one that ``raft_tpu``
built, carried into the port through ``serialize``, and one the port
built, carried into the JAX package the same way.  Each is searched in the
six scan modes at k 5 and k 100 at full probe (every list, so the coarse
ranking cannot differ) by both packages' public ``search``.  The JAX
package resolves every mode to its recon scan (the recon cache is there)
or its lookup-table scan and scores the metric as L2; so must the port.
Tolerances are each route's own: the recon scans within 1e-4 (bf16
products summed in another order), the fp32 lookup table within 1e-5;
ids equal but among ties at a row's edge.  A fused request (``auto``,
``fused``) counts one fallback with the Pallas gate's reason ``"dtype"``.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.neighbors import ivf_pq

CPU = DeviceResources(device="cpu")
N_LISTS, PQ_DIM = 12, 10
METRICS = {"cosine": 2, "l1": 3, "correlation": 10}
MODES = ("auto", "fused", "codes", "recon8", "recon", "lut")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows():
    x = np.random.default_rng(0).standard_normal((3030, 40)).astype(
        np.float32)
    return x[:3000], x[3000:]


def _params(metric, jax=False):
    mod = jax_ivf_pq if jax else ivf_pq
    return mod.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                           kmeans_n_iters=4, metric=metric)


_BUILT = {}


def _indexes(rows, source, metric):
    """``(JAX index, port index)`` of one build, carried across."""
    key = source, metric
    if key not in _BUILT:
        db, _ = rows
        buf = io.BytesIO()
        if source == "jax":
            jidx = jax_ivf_pq.build(JaxResources(seed=metric),
                                    _params(metric, jax=True), db)
            jax_ivf_pq.serialize(JaxResources(seed=0), buf, jidx)
            port = ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()))
        else:
            port = ivf_pq.build(DeviceResources(seed=metric, device="cpu"),
                                _params(metric), db)
            ivf_pq.serialize(CPU, buf, port)
            jidx = jax_ivf_pq.deserialize(JaxResources(seed=0),
                                          io.BytesIO(buf.getvalue()))
        assert port.metric == jidx.metric == metric
        _BUILT[key] = jidx, port
    return _BUILT[key]


def _assert_same(d, i, rd, ri, rtol):
    """Distances within ``rtol`` (relative, ``rtol`` absolute floor), the
    same exhausted ranks, the same ids strictly inside each row's last
    kept distance less the tolerance."""
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_array_equal(i == -1, ~fin)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=rtol, atol=rtol)
    for prow, pids, rrow, rids in zip(d, i, rd, ri):
        f = np.isfinite(rrow)
        if f.any():
            cut = rrow[f][-1] - 2 * rtol * (1 + abs(rrow[f][-1]))
            assert (set(pids[np.isfinite(prow) & (prow < cut)])
                    == set(rids[f & (rrow < cut)]))


@pytest.mark.parametrize("k", [5, 100])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", list(METRICS.values()),
                         ids=list(METRICS))
@pytest.mark.parametrize("source", ["jax", "port"])
def test_search_at_a_metric_scored_as_l2_matches_the_jax_package(
        rows, source, metric, mode, k):
    _, q = rows
    jidx, port = _indexes(rows, source, metric)
    sp = dict(n_probes=N_LISTS, scan_mode=mode)
    rd, ri = jax_ivf_pq.search(JaxResources(seed=0), jax_ivf_pq.SearchParams(
        exact_coarse=True, **sp), jidx, jnp.asarray(q), k)
    before = ivf_pq.search.fused_fallbacks
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(**sp), port, q, k)
    fused = mode in ("auto", "fused")
    assert ivf_pq.search.fused_fallbacks == before + int(fused)
    if fused:
        assert ivf_pq.search.last_fallback_reason == "dtype"
    assert d.shape == i.shape == (q.shape[0], k)
    _assert_same(d.numpy(), i.numpy(), np.asarray(rd), np.asarray(ri),
                 1e-5 if mode == "lut" else 1e-4)


@pytest.mark.parametrize("metric", list(METRICS.values()),
                         ids=list(METRICS))
def test_a_metric_scored_as_l2_gives_the_l2_result(rows, metric):
    """The same lists searched at the metric and at L2Expanded agree bit
    for bit: the metric changes no distance, only the fused gate."""
    _, q = rows
    _, port = _indexes(rows, "jax", metric)
    l2 = ivf_pq.Index(**{**port.__dict__, "metric": 0})
    sp = ivf_pq.SearchParams(n_probes=N_LISTS, scan_mode="recon")
    d, i = ivf_pq.search(CPU, sp, port, q, 10)
    d2, i2 = ivf_pq.search(CPU, sp, l2, q, 10)
    np.testing.assert_array_equal(d.numpy(), d2.numpy())
    np.testing.assert_array_equal(i.numpy(), i2.numpy())
