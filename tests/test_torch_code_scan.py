"""raft_tpu_torch's compact-code scans (Kernels C, D, E) against the JAX
package, on the CPU.

A ``raft_tpu``-built index, with the JAX package's own code and int8
caches, is carried across with ``index_from_numpy``.  Each kernel's plain
version is held to the JAX function that runs its Pallas kernel (in
interpret mode) at the same probes — the port's exact ranking — with
distances within 1e-4 rel/abs and ids overlapping at >= 0.99, as
tests/test_torch_ivf_pq.py holds Kernel B.  Searches run at
``packed_extract=False``: the port never truncates mantissa bits."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import grouped
from raft_tpu.neighbors import ivf_pq as jax_ivf_pq
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors.ivf_flat import _select_clusters
from raft_tpu_torch.ops import pq_code_scan as pcs

LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
          "list_sizes", "rotation", "list_recon", "list_recon_sq",
          "list_code_rsq", "list_recon_i8", "list_recon_scale",
          "list_recon_i8_sq")
K, N_PROBES = 10, 8
CPU = DeviceResources(device="cpu")


def _overlap(a, b, k=K):
    return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])


def _assert_same_results(pd, pi, rd, ri, pq_bits=8):
    """Distances within 1e-4 at every rank, the same exhausted ranks, and
    the same ids at every rank strictly below a row's k-th distance (ids
    may differ only among candidates tied at the k-th distance, which the
    two top-k selections break differently).  Id overlap >= 0.99; at 4
    bits a subspace has 16 codewords, rows decode to identical vectors
    and exact ties are common, so there >= 0.95."""
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_array_equal(pi == -1, ~np.isfinite(pd))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=1e-4, atol=1e-4)
    for prow, pids, rrow, rids in zip(pd, pi, rd, ri):
        if np.isfinite(rrow).any():
            edge = rrow[np.isfinite(rrow)][-1]
            margin = 1e-4 * (1.0 + abs(edge))
            assert (set(pids[prow < edge - margin])
                    == set(rids[rrow < edge - margin]))
    assert _overlap(pi, ri) >= (0.99 if pq_bits == 8 else 0.95)


def _carry(index, **drop):
    arrays = {n: (None if n in drop or getattr(index, n, None) is None
                  else np.asarray(getattr(index, n))) for n in LEAVES}
    return ivf_pq.index_from_numpy(arrays, metric=index.metric,
                                   pq_bits=index.pq_bits, device="cpu")


def _zap(list_indices):
    """Every other slot's id set to -1 (tests/test_ivf_pq.py's zapped
    case): those rows must never surface."""
    ids = np.asarray(list_indices)
    return np.where(np.arange(ids.shape[1])[None, :] % 2 == 0, ids, -1)


@pytest.fixture(scope="module")
def carried():
    """One small JAX-built index per pq_bits with its code and int8 caches
    attached by the JAX package, the port's copy, the port's exact probes
    and the group count the JAX grouped scans need."""
    X, _ = make_blobs(4000, 32, n_clusters=64, cluster_std=1.0, seed=5)
    db, q = np.asarray(X[:3800]), np.asarray(X[3800:3850])
    res = JaxResources(seed=42)
    out = {}
    for pq_bits in (8, 4):
        index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
            n_lists=16, pq_dim=8, pq_bits=pq_bits, kmeans_n_iters=5), db)
        index = jax_ivf_pq._with_recon8(jax_ivf_pq._with_code_lanes(index))
        port = _carry(index)
        qrot = torch.from_numpy(q) @ port.rotation
        probes = _select_clusters(port.centers, qrot, N_PROBES, port.metric)
        ng = grouped.round_groups(int(grouped.num_groups(
            jnp.asarray(probes.numpy()), index.n_lists)))
        out[pq_bits] = (index, port, qrot, probes, ng)
    return db, q, out


def _case(carried, pq_bits, zapped):
    db, q, built = carried
    index, port, qrot, probes, ng = built[pq_bits]
    ids = _zap(index.list_indices) if zapped else np.asarray(
        index.list_indices)
    return (index, port, q, qrot, probes, ng, jnp.asarray(ids),
            torch.from_numpy(ids))


CASES = [(b, kt, z) for b in (8, 4) for kt in (0, 4) for z in (False, True)]
IDS = [f"bits{b}-kt{kt}{'-zapped' if z else ''}" for b, kt, z in CASES]


@pytest.mark.parametrize("pq_bits,kt,zapped", CASES, ids=IDS)
def test_kernel_c_plain_matches_jax_fused_codes(carried, pq_bits, kt,
                                                zapped):
    index, port, q, qrot, probes, ng, jids, tids = _case(carried, pq_bits,
                                                         zapped)
    rd, ri = jax_ivf_pq._search_impl_fused_codes_grouped(
        index.centers, index.codebooks, index.list_code_lanes,
        index.list_code_rsq, jids, index.rotation, jnp.asarray(q),
        jnp.asarray(probes.numpy()), K, kt, index.metric, ng, pq_bits,
        pallas_interpret=True)
    vals, found = pcs.ivf_pq_scan_codes_fused(
        qrot, port.centers, probes, port.list_codes, port.codebooks,
        port.list_code_rsq, tids, pq_bits, K, min(kt or K, port.capacity))
    pd = ivf_pq._sqrt_epilogue(vals, port.metric).numpy()
    _assert_same_results(pd, found.numpy(), np.asarray(rd), np.asarray(ri),
                         pq_bits)
    if zapped:
        live = set(tids[tids >= 0].tolist())
        assert all(int(i) in live for i in found[found >= 0])


@pytest.mark.parametrize("pq_bits,kt,zapped", CASES, ids=IDS)
def test_kernel_d_plain_matches_jax_codes(carried, pq_bits, kt, zapped):
    index, port, q, qrot, probes, ng, jids, tids = _case(carried, pq_bits,
                                                         zapped)
    rd, ri = jax_ivf_pq._search_impl_codes_grouped(
        index.centers, index.codebooks, index.list_code_lanes,
        index.list_code_rsq, jids, index.rotation, jnp.asarray(q),
        jnp.asarray(probes.numpy()), K, kt, index.metric, ng, pq_bits,
        pallas_interpret=True)
    kt_eff = min(kt or K, port.capacity)
    vals, found = pcs.ivf_pq_scan_codes(
        qrot, port.centers, probes, port.list_codes, port.codebooks,
        port.list_code_rsq, tids, pq_bits, kt_eff)
    assert vals.shape == (q.shape[0], N_PROBES, kt_eff)
    pd, pi = ivf_pq._finalize_topk(vals, found, K, port.metric)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), pq_bits)


@pytest.mark.parametrize("pq_bits,kt,zapped", CASES, ids=IDS)
def test_kernel_e_plain_matches_jax_recon8(carried, pq_bits, kt, zapped):
    index, port, q, qrot, probes, ng, jids, tids = _case(carried, pq_bits,
                                                         zapped)
    rd, ri = jax_ivf_pq._search_impl_recon8_grouped(
        index.centers, index.list_recon_i8, index.list_recon_scale,
        index.list_recon_i8_sq, jids, index.rotation, jnp.asarray(q),
        jnp.asarray(probes.numpy()), K, kt, index.metric, ng, 64,
        use_pallas=True, pallas_interpret=True)
    vals, found = pcs.ivf_pq_scan_recon8(
        qrot, port.centers, probes, port.list_recon_i8,
        port.list_recon_scale, port.list_recon_i8_sq, tids,
        min(kt or K, port.capacity))
    pd, pi = ivf_pq._finalize_topk(vals, found, K, port.metric)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri), pq_bits)


def test_per_pair_outputs_pad_exhausted_slots_and_skip_bad_probes(carried):
    """A pair keeps at most its live rows, then (+inf, -1); a probe
    outside [0, n_lists) gives a whole (+inf, -1) row; within a pair the
    kept distances ascend."""
    _, port, _, qrot, probes, _, _, _ = _case(carried, 8, False)
    pr = probes[:3].clone()
    pr[0, 1] = -1
    pr[1, 2] = port.n_lists
    big = port.capacity
    for vals, found in (
            pcs.ivf_pq_scan_codes(qrot[:3], port.centers, pr,
                                  port.list_codes, port.codebooks,
                                  port.list_code_rsq, port.list_indices, 8,
                                  big),
            pcs.ivf_pq_scan_recon8(qrot[:3], port.centers, pr,
                                   port.list_recon_i8, port.list_recon_scale,
                                   port.list_recon_i8_sq, port.list_indices,
                                   big)):
        assert vals.shape == (3, N_PROBES, big)
        assert torch.isinf(vals[0, 1]).all() and (found[0, 1] == -1).all()
        assert torch.isinf(vals[1, 2]).all() and (found[1, 2] == -1).all()
        live = (port.list_indices[probes[2].long()] >= 0).sum(1)
        for p, n_live in enumerate(live.tolist()):
            assert torch.isfinite(vals[2, p, :n_live]).all()
            assert torch.isinf(vals[2, p, n_live:]).all()
            assert (found[2, p, n_live:] == -1).all()
            kept = vals[2, p, :n_live]
            assert bool((kept[1:] >= kept[:-1]).all())


@pytest.mark.parametrize("pq_bits", [8, 4])
def test_rsq_from_codes_matches_jax(carried, pq_bits):
    _, _, built = carried
    index, port, *_ = built[pq_bits]
    got = ivf_pq._rsq_from_codes(port.codebooks, port.list_codes,
                                 port.pq_dim, port.pq_bits)
    want = jax_ivf_pq._rsq_from_codes(index.codebooks, index.list_codes,
                                      index.pq_dim, index.pq_bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), port.list_code_rsq.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def per_cluster():
    """A per-cluster index ``raft_tpu`` built (seed 1) over 3,000 x 40
    standard-normal rows, ``n_lists=12``, ``pq_dim=10``, with its int8
    cache, and its serialized stream."""
    x = np.random.default_rng(0).standard_normal((3000, 40)).astype(
        np.float32)
    res = JaxResources(seed=1)
    index = jax_ivf_pq.build(res, jax_ivf_pq.IndexParams(
        n_lists=12, pq_dim=10, kmeans_n_iters=4, codebook_kind=1), x)
    index = jax_ivf_pq._with_recon8(index)
    buf = io.BytesIO()
    jax_ivf_pq.serialize(res, buf, index)
    return index, buf.getvalue()


@pytest.mark.parametrize("case", [8, 4, "per-cluster"])
def test_quantize_recon_gives_the_jax_int8_cache_exactly(carried,
                                                         per_cluster, case):
    """Same int8 rows, scales and dequantized norms bit for bit, from the
    recon cache and from an index without one (decoded on the fly); the
    port pads rows to 16 bytes where the JAX package pads to 128.  The
    per-cluster index has list maxima whose ``x / 127`` and ``x · f32(1 /
    127)`` round apart (XLA folds the division into the product)."""
    if case == "per-cluster":
        index, stream = per_cluster
        port = ivf_pq.deserialize(CPU, io.BytesIO(stream))
        bare = ivf_pq.deserialize(CPU, io.BytesIO(stream),
                                  cache_reconstructions=False)
        maxabs = np.abs(np.asarray(index.list_recon, np.float32)).max(
            axis=(1, 2))
        assert (maxabs / np.float32(127)
                != maxabs * (np.float32(1) / np.float32(127))).any()
    else:
        _, _, built = carried
        index, port, *_ = built[case]
        bare = _carry(index, list_recon=1, list_recon_sq=1,
                      list_recon_i8=1, list_recon_scale=1,
                      list_recon_i8_sq=1)
    rot = port.rot_dim
    qi, scale, rsq8 = ivf_pq._quantize_recon(port.list_recon, 128)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(index.list_recon_i8))
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(index.list_recon_scale))
    np.testing.assert_array_equal(rsq8.numpy(),
                                  np.asarray(index.list_recon_i8_sq))
    ivf_pq._with_recon8(bare)
    assert bare.list_recon is None
    assert bare.list_recon_i8.shape[2] == ivf_pq._round_up(rot, 16)
    np.testing.assert_array_equal(bare.list_recon_i8[:, :, :rot].numpy(),
                                  np.asarray(index.list_recon_i8)[:, :, :rot])
    assert not bare.list_recon_i8[:, :, rot:].any()
    np.testing.assert_array_equal(bare.list_recon_scale.numpy(),
                                  np.asarray(index.list_recon_scale))
    np.testing.assert_array_equal(bare.list_recon_i8_sq.numpy(),
                                  np.asarray(index.list_recon_i8_sq))


def test_quantize_recon_of_an_all_zero_list_has_scale_one():
    recon = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    recon[1, 0, 3] = -2.5
    qi, scale, rsq8 = ivf_pq._quantize_recon(recon, 16)
    assert scale.tolist() == [1.0, float(np.float32(2.5) / np.float32(127))]
    assert qi.shape == (2, 4, 16) and int(qi[1, 0, 3]) == -127
    assert float(rsq8[1, 0]) == pytest.approx(2.5 ** 2, rel=1e-6)


# the JAX function each public mode resolves to, with its kernel
# interpreted, at the port's probes
def _jax_reference(index, q, probes, ng, mode, kt):
    args = (jnp.asarray(q), jnp.asarray(probes.numpy()), K, kt,
            index.metric, ng)
    if mode == "fused_recon":
        return jax_ivf_pq._search_impl_fused_recon_grouped(
            index.centers, index.list_recon, index.list_recon_sq,
            index.list_indices, index.rotation, *args,
            pallas_interpret=True)
    if mode == "recon8":
        return jax_ivf_pq._search_impl_recon8_grouped(
            index.centers, index.list_recon_i8, index.list_recon_scale,
            index.list_recon_i8_sq, index.list_indices, index.rotation,
            *args, 64, use_pallas=True, pallas_interpret=True)
    fn = (jax_ivf_pq._search_impl_fused_codes_grouped if mode == "fused_codes"
          else jax_ivf_pq._search_impl_codes_grouped)
    return fn(index.centers, index.codebooks, index.list_code_lanes,
              index.list_code_rsq, index.list_indices, index.rotation,
              *args, index.pq_bits, pallas_interpret=True)


@pytest.mark.parametrize("scan_mode,recon,resolves_to", [
    ("auto", True, "fused_recon"),
    ("auto", False, "fused_codes"),
    ("fused", True, "fused_codes"),
    ("codes", True, "codes"),
    ("recon8", True, "recon8"),
    ("recon8", False, "recon8"),
])
def test_public_search_matches_the_jax_function_it_resolves_to(
        carried, scan_mode, recon, resolves_to):
    _, q, built = carried
    index, _, _, probes, ng = built[8]
    if not recon:
        index = jax_ivf_pq._with_recon8(jax_ivf_pq._with_code_lanes(
            dataclasses.replace(index, list_recon=None, list_recon_sq=None,
                                list_code_lanes=None, list_code_rsq=None,
                                list_recon_i8=None)))
    port = _carry(index, list_code_rsq=1, list_recon_i8=1,
                  list_recon_scale=1, list_recon_i8_sq=1)
    kt = 4 if scan_mode != "auto" else 0
    pd, pi = ivf_pq.search(
        DeviceResources(device="cpu"),
        ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=scan_mode,
                            per_probe_topk=kt), port, q, K)
    rd, ri = _jax_reference(index, q, probes, ng, resolves_to, kt)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri))


@pytest.mark.parametrize("kt", [2, 64])
def test_recon8_search_matches_the_jax_grouped_recon8(carried, kt):
    """``ivf_pq.search(scan_mode="recon8")`` on the carried 8-bit index
    against the JAX package's ``_search_impl_recon8_grouped`` (its Pallas
    scan interpreted) at a small kt and at 64, the list-major route's
    largest (kt 4: the test above)."""
    _, q, built = carried
    index, port, _, probes, ng = built[8]
    pd, pi = ivf_pq.search(
        DeviceResources(device="cpu"),
        ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon8",
                            per_probe_topk=kt), port, q, K)
    rd, ri = _jax_reference(index, q, probes, ng, "recon8", kt)
    _assert_same_results(pd.numpy(), pi.numpy(), np.asarray(rd),
                         np.asarray(ri))


@pytest.mark.parametrize("scan_mode", ["auto", "fused", "codes", "recon8"])
def test_public_search_agrees_with_jax_search(carried, scan_mode):
    """Against the JAX public search at exact_coarse=True, by id overlap
    only: off the TPU the JAX search sends "codes" and "fused" to its LUT
    formulation and "recon8" / "auto" to XLA twins of its kernels, whose
    top-k differ from the kernels' at distance ties, so exact equality is
    not expected here (the kernel parity tests above hold the
    distances)."""
    _, q, built = carried
    index, port, *_ = built[8]
    sp = dict(n_probes=N_PROBES, exact_coarse=True, scan_mode=scan_mode)
    _, ri = jax_ivf_pq.search(JaxResources(seed=0),
                              jax_ivf_pq.SearchParams(**sp), index,
                              jnp.asarray(q), K)
    _, pi = ivf_pq.search(DeviceResources(device="cpu"),
                          ivf_pq.SearchParams(**sp), port, q, K)
    assert _overlap(pi.numpy(), np.asarray(ri)) >= 0.95


@pytest.mark.parametrize("scan_mode", ["codes", "recon8"])
def test_extend_leaves_no_stale_scan_cache(carried, scan_mode):
    """A search attaches the mode's cache; extend returns an index without
    it, so the next search derives it again: results equal those of a
    fresh carry of the extended index, and the new rows are found."""
    db, q, built = carried
    index, *_ = built[8]
    res = DeviceResources(device="cpu")
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=scan_mode)
    port = _carry(index, list_code_rsq=1, list_recon_i8=1,
                  list_recon_scale=1, list_recon_i8_sq=1)
    ivf_pq.search(res, sp, port, q, K)
    assert (port.list_code_rsq if scan_mode == "codes"
            else port.list_recon_i8) is not None
    new = q[:6] + np.float32(0.01)
    ext = ivf_pq.extend(res, port, new)
    assert ext.list_code_rsq is None and ext.list_recon_i8 is None
    d, i = ivf_pq.search(res, sp, ext, new, K)
    fresh = ivf_pq.index_from_numpy(
        {n: _as_numpy(getattr(ext, n)) for n in LEAVES[:8]},
        metric=ext.metric, pq_bits=ext.pq_bits, device="cpu")
    fd, fi = ivf_pq.search(res, sp, fresh, new, K)
    assert torch.equal(i, fi) and torch.equal(d, fd)
    new_ids = torch.arange(index.size, index.size + 6, dtype=torch.int32)
    assert bool((i == new_ids[:, None]).any(1).all())


def _as_numpy(t):
    """A port tensor as the numpy array a JAX leaf would give (bf16 as the
    ml_dtypes bfloat16 dtype)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def odd_bits_index():
    """A port-built pq_bits 5 index without a recon cache: the JAX
    package sends its fused / codes / auto searches to the LUT scan."""
    rng = np.random.default_rng(3)
    db = rng.normal(size=(700, 16)).astype(np.float32)
    res = DeviceResources(seed=0, device="cpu")
    index = ivf_pq.build(res, ivf_pq.IndexParams(
        n_lists=8, pq_dim=8, pq_bits=5, kmeans_n_iters=3,
        cache_reconstructions=False), db)
    return res, index, db


@pytest.mark.parametrize("change", [
    dict(scan_mode="auto"), dict(scan_mode="fused"),
    dict(scan_mode="codes"), dict(use_reconstruction=False)],
    ids=["auto", "fused", "codes", "use_reconstruction_false"])
def test_searches_resolving_to_lut_raise(odd_bits_index, change):
    """Each search the JAX package sends to the LUT scan runs the port's
    (shipped): the JAX package's ``_search_impl`` on the same arrays and
    probes gives the same result (fp32 LUT: distances within 1e-5
    relative, ids tie-aware), and a fused or auto request counts one
    fallback, reason "mode"."""
    res, index, db = odd_bits_index
    before = ivf_pq.search.fused_fallbacks
    d, i = ivf_pq.search(res, ivf_pq.SearchParams(n_probes=8, **change),
                         index, db[:6], 5)
    fused = change.get("scan_mode") in ("auto", "fused")
    assert ivf_pq.search.fused_fallbacks == before + int(fused)
    if fused:
        assert ivf_pq.search.last_fallback_reason == "mode"
    rd, ri = jax_ivf_pq._search_impl(
        index.centers.numpy(), index.codebooks.numpy(),
        index.list_codes.numpy(), index.list_indices.numpy(),
        index.rotation.numpy(), jnp.asarray(db[:6]), 5, 8, index.metric,
        index.codebook_kind, "float32", pq_bits=5, exact_coarse=True)
    rd, ri = np.asarray(rd), np.asarray(ri)
    np.testing.assert_allclose(d.numpy(), rd, rtol=1e-5, atol=1e-5)
    for prow, pids, rrow, rids in zip(d.numpy(), i.numpy(), rd, ri):
        inner = rrow < rrow[-1] - 1e-4 * (1 + rrow[-1])
        assert set(pids[inner]) == set(rids[inner])


def test_recon8_serves_an_index_the_code_scans_cannot(odd_bits_index):
    """recon8 needs no code-scan eligibility (as in the JAX package): a
    pq_bits 5 index without a recon cache decodes into the int8 cache and
    every row finds itself."""
    res, index, db = odd_bits_index
    _, found = ivf_pq.search(res, ivf_pq.SearchParams(
        n_probes=8, scan_mode="recon8"), index, db[:20], 5)
    assert index.list_recon is None and index.list_recon_i8 is not None
    assert (found[:, 0] == torch.arange(20, dtype=torch.int32)).float(
    ).mean() >= 0.9


@pytest.mark.parametrize("shape,reason", [
    (dict(cap=64, rot=32, pq_dim=8, pq_bits=5, k=10, kt=4), "pq_bits=5"),
    (dict(cap=64, rot=30, pq_dim=8, pq_bits=8, k=10, kt=4), "multiple"),
    (dict(cap=64, rot=32, pq_dim=8, pq_bits=8, k=300, kt=4), "k=300"),
    (dict(cap=40_000, rot=96, pq_dim=48, pq_bits=8, k=200, kt=200),
     "shared memory"),
])
def test_code_scan_gates_name_their_reason(shape, reason):
    """Kernels C and D's gates refuse only where every route does, and
    then name each route's reason: a capacity past the query-major
    kernel's shared memory is refused only where a pair keeps more than
    128 candidates (the list-major and pair-group routes take any
    capacity)."""
    got = pcs.codes_fused_reject_reason(**shape)
    assert reason in got
    if reason == "shared memory":
        assert "list-major" in got and "query-major route" in got
        assert "pair-group route" in got
        assert not pcs.codes_fused_reject_reason(**dict(shape, k=100))
        assert not pcs.codes_fused_reject_reason(**dict(shape, k=10))
    assert not pcs.codes_fused_reject_reason(
        cap=2048, rot=96, pq_dim=48, pq_bits=8, k=20, kt=4)
    assert "kt=129" in pcs.codes_reject_reason(64, 32, 8, 8, 129)
    assert "16" in pcs.recon8_reject_reason(64, 24, 4)
    assert not pcs.recon8_reject_reason(4096, 96, 4)
    # a capacity past Kernel E's query-major shared memory: the
    # list-major route takes it up to kt 64, the pair-group pass up to
    # 128, and above all three are named
    assert pcs.recon8_query_major_reject_reason(100_000, 96, 4)
    assert not pcs.recon8_reject_reason(100_000, 96, 64)
    assert not pcs.recon8_reject_reason(100_000, 96, 65)
    assert "query-major route" in pcs.recon8_reject_reason(100_000, 96, 129)


@pytest.mark.parametrize("refused", ["capacity", "k"])
def test_fused_codes_fallback_is_counted_with_its_reason(carried, monkeypatch,
                                                         refused):
    """Where Kernel C's gate refuses the shape (here a capacity past a
    shared-memory limit lowered below its three routes, or k past 256), a
    fused search runs
    Kernel D + finalize, as the JAX package's fused_fallback does: the
    same results as scan_mode="codes", one count, the gate's reason."""
    _, q, built = carried
    port = _carry(built[8][0])
    k, word = K, "shared memory"
    if refused == "capacity":          # below all three of C's routes
        limit = min(
            pcs.codes_fused_smem_bytes(port.capacity, port.rot_dim,
                                       port.pq_dim, 8),
            pcs.code_list_scan_smem_bytes(port.rot_dim, port.pq_dim, 8, 4),
            pcs.code_pair_list_layout(port.rot_dim, port.pq_dim, 8, 4,
                                      group=32).total) - 1
        monkeypatch.setattr(pcs, "_SMEM_LIMIT", limit)
        monkeypatch.setattr(pcs.ps, "_SMEM_LIMIT", limit)
    else:
        k, word = 300, "k=300"
    res = DeviceResources(device="cpu")

    def run(scan_mode, k):
        return ivf_pq.search(res, ivf_pq.SearchParams(
            n_probes=N_PROBES, scan_mode=scan_mode, per_probe_topk=4),
            port, q, k)

    before = ivf_pq.search.fused_fallbacks
    d, i = run("fused", k)
    assert ivf_pq.search.fused_fallbacks == before + 1
    assert word in ivf_pq.search.last_fallback_reason
    cd, ci = run("codes", k)
    assert torch.equal(d, cd) and torch.equal(i, ci)
    monkeypatch.undo()
    run("fused", K)                    # a shape Kernel C takes
    assert ivf_pq.search.fused_fallbacks == before + 1


def test_build_records_its_stage_seconds():
    rng = np.random.default_rng(4)
    db = rng.normal(size=(600, 16)).astype(np.float32)
    ivf_pq.build(DeviceResources(seed=0, device="cpu"), ivf_pq.IndexParams(
        n_lists=8, pq_dim=8, kmeans_n_iters=3), db)
    stages = ivf_pq.build.stage_seconds
    assert list(stages) == ["trainset", "coarse_fit", "codebooks",
                            "encode_and_pack", "recon_cache"]
    assert all(s >= 0.0 for s in stages.values())


def test_recon8_beyond_its_kernel_raises(carried, monkeypatch):
    """kt above 128 is past Kernel E, where the JAX package runs its XLA
    twin: the port runs the twin's composition (shipped), and the JAX
    package's recon8 search at kt 129 gives the same result (within
    1e-4, ids tie-aware).  A capacity only the query-major kernel refuses
    (its shared memory made to exceed the card here) is served by the
    list-major route at kt <= 64 and by the composition above, equal to
    the kernel's plain version bit for bit."""
    _, q, built = carried
    port = _carry(built[8][0])
    assert port.capacity > 129
    res = DeviceResources(device="cpu")

    def search(kt):
        return ivf_pq.search(res, ivf_pq.SearchParams(
            n_probes=N_PROBES, scan_mode="recon8", per_probe_topk=kt),
            port, q[:2], K)

    got = search(129)
    rd, ri = jax_ivf_pq.search(JaxResources(seed=0), jax_ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="recon8", per_probe_topk=129,
        exact_coarse=True), built[8][0], q[:2], K)
    _assert_same_results(got[0].numpy(), got[1].numpy(), np.asarray(rd),
                         np.asarray(ri))
    want, want65 = search(64), search(65)
    monkeypatch.setattr(pcs, "recon8_smem_bytes",
                        lambda cap, rot_pad: pcs._SMEM_LIMIT + 1)
    got = search(64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = search(65)
    assert torch.equal(got[0], want65[0]) and torch.equal(got[1], want65[1])
