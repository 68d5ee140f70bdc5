"""The port's LUT scan (``scan_mode="lut"``) against the JAX package's
``_search_impl``, on the CPU.

Indexes are built by ``raft_tpu`` (per-subspace and per-cluster books, at
pq_bits 4, 5 and 8), rows deleted there (tombstones in ``list_indices``),
and carried into the port through ``serialize`` / ``deserialize``; each
case searches both at the same exact coarse ranking under L2Expanded,
L2SqrtExpanded and InnerProduct, with and without a per-query filter.
Tolerances: an fp32 LUT gives distances within 1e-5 relative and the same
ids except among ties at a row's edge; a bf16 LUT (the table rounded, the
sum in fp32) gives distances within pq_dim · 2⁻⁸ · max|LUT|, and ids
equal except within that band of a row's edge.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.filters import bitset as jax_bitset
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_pq

CPU = DeviceResources(device="cpu")
N_LISTS, N_PROBES, K, PQ_DIM = 12, 5, 10, 8
METRICS = {"l2": DistanceType.L2Expanded,
           "l2sqrt": DistanceType.L2SqrtExpanded,
           "ip": DistanceType.InnerProduct}
KINDS = {"subspace": 0, "cluster": 1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(1600, 16, n_clusters=24, cluster_std=1.5, seed=11)
    X = np.asarray(X)
    return X[:1560], X[1560:]


@pytest.fixture(scope="module")
def built(data):
    """(kind, pq_bits) -> (JAX index with 40 rows deleted, the port's copy
    through the stream)."""
    db, _ = data
    out = {}
    for kind in KINDS.values():
        for bits in (4, 5, 8):
            res = JaxResources(seed=kind * 10 + bits)
            index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
                n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=bits,
                kmeans_n_iters=4, codebook_kind=kind,
                cache_reconstructions=False), db)
            index = jax_ivf_pq.delete(res, index, np.arange(0, 1560, 39))
            buf = io.BytesIO()
            jax_ivf_pq.serialize(res, buf, index)
            port = ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()),
                                      cache_reconstructions=False)
            out[kind, bits] = (index, port)
    return out


def _with_metric(port, metric):
    return ivf_pq.Index(**{**port.__dict__, "metric": metric})


def _reference(index, q, metric, lut_dtype, mask):
    fw = (None if mask is None else
          jax_bitset.query_filter_words(mask, q.shape[0], "test"))
    d, i = jax_ivf_pq._search_impl(
        index.centers, index.codebooks, index.list_codes,
        index.list_indices, index.rotation, jnp.asarray(q), K, N_PROBES,
        metric, index.codebook_kind, lut_dtype, pq_bits=index.pq_bits,
        exact_coarse=True, filter_words=fw)
    return np.asarray(d), np.asarray(i)


def _max_abs_lut(port, q, metric):
    """max |LUT entry| over every query and list: the bf16 tolerance's
    scale."""
    qrot = torch.from_numpy(q) @ port.rotation
    cb = port.codebooks.float()
    sub = (qrot[:, None, :] if metric == DistanceType.InnerProduct
           else qrot[:, None, :] - port.centers[None]).reshape(
        q.shape[0], -1, PQ_DIM, cb.shape[2])          # (q, L | 1, j, l)
    if port.codebook_kind == 0:
        ip = torch.einsum("qajl,jkl->qajk", sub, cb)
        bsq = (cb * cb).sum(-1)[None, None]
    else:
        ip = torch.einsum("qajl,akl->qajk", sub, cb)
        bsq = (cb * cb).sum(-1)[None, :, None, :]
    lut = ip if metric == DistanceType.InnerProduct else bsq - 2.0 * ip
    return float(lut.abs().max())


def _assert_same(d, i, rd, ri, tol, metric):
    """Distances within ``tol`` (a scalar or per-element array), the same
    exhausted ranks, and the same ids strictly inside each row's last
    distance less ``tol``."""
    sign = -1.0 if metric == DistanceType.InnerProduct else 1.0
    d, rd = sign * d, sign * rd                 # ascending in both cases
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_array_equal(i == -1, ~fin)
    tol = np.broadcast_to(np.asarray(tol, dtype=np.float64), d.shape)
    assert np.all(np.abs(d[fin] - rd[fin]) <= tol[fin]), \
        np.abs(d[fin] - rd[fin]).max()
    for prow, pids, rrow, rids, trow in zip(d, i, rd, ri, tol):
        f = np.isfinite(rrow)
        if f.any():
            cut = rrow[f][-1] - 2 * trow[f].max()
            assert (set(pids[np.isfinite(prow) & (prow < cut)])
                    == set(rids[f & (rrow < cut)]))


CASES = [(m, k, b, f) for m in METRICS for k in KINDS for b in (4, 5, 8)
         for f in (False, True)]


@pytest.mark.parametrize("metric,kind,bits,filtered", CASES,
                         ids=[f"{m}-{k}-bits{b}{'-filtered' if f else ''}"
                              for m, k, b, f in CASES])
def test_lut_scan_matches_the_jax_package_fp32(data, built, metric, kind,
                                               bits, filtered):
    db, q = data
    index, port = built[KINDS[kind], bits]
    m = METRICS[metric]
    mask = (np.random.default_rng(bits).random((q.shape[0], 1560)) < 0.5
            if filtered else None)
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="lut"), _with_metric(port, m), q, K,
        filter=mask)
    rd, ri = _reference(index, q, m, "float32", mask)
    fin = np.isfinite(rd)
    _assert_same(d.numpy(), i.numpy(), rd, ri,
                 1e-5 * np.maximum(np.abs(np.where(fin, rd, 0)), 1.0), m)
    assert not set(i.numpy()[i.numpy() >= 0].tolist()) & set(
        range(0, 1560, 39))                        # tombstones never return
    if mask is not None:
        rows, cols = np.nonzero(i.numpy() >= 0)
        assert mask[rows, i.numpy()[rows, cols]].all()


BF16 = [(m, k) for m in METRICS for k in KINDS]


@pytest.mark.parametrize("metric,kind", BF16,
                         ids=[f"{m}-{k}" for m, k in BF16])
def test_lut_scan_matches_the_jax_package_bf16(data, built, metric, kind):
    db, q = data
    index, port = built[KINDS[kind], 8]
    m = METRICS[metric]
    port = _with_metric(port, m)
    d, i = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="lut", lut_dtype=torch.bfloat16),
        port, q, K)
    rd, ri = _reference(index, q, m, "bfloat16", None)
    tol = PQ_DIM * 2.0 ** -8 * _max_abs_lut(port, q, m)
    if m == DistanceType.L2SqrtExpanded:
        # sqrt's slope at the row's smallest distance bounds the change
        tol = tol / (2.0 * max(float(np.min(rd[np.isfinite(rd)])), 1e-3))
    _assert_same(d.numpy(), i.numpy(), rd, ri, tol, m)


@pytest.mark.parametrize("name", ["float32", torch.float32, "bfloat16",
                                  torch.bfloat16, np.float32])
def test_lut_dtype_is_read_as_the_jax_package_reads_it(built, name):
    _, port = built[0, 8]
    assert ivf_pq._lut_dtype(name) in (torch.float32, torch.bfloat16)
    with pytest.raises(Exception, match="lut_dtype"):
        ivf_pq._lut_dtype("int8")


def test_lut_scan_keeps_min_k_capacity_a_probe_whatever_per_probe_topk(
        data, built):
    """The LUT scan keeps kt = min(k, capacity) rows a probe, as the JAX
    package's: per_probe_topk does not change its result."""
    _, q = data
    _, port = built[0, 8]
    base = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="lut"), port, q, K)
    narrow = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="lut", per_probe_topk=1), port, q, K)
    assert torch.equal(base[0], narrow[0]) and torch.equal(base[1],
                                                           narrow[1])
