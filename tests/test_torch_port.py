"""raft_tpu_torch on the CPU: package boundary, handle, helpers, and the
paths this slice leaves for later (each must raise NotImplementedError
naming its ROADMAP item rather than take another route)."""

import ast
import io
import pathlib

import numpy as np
import pytest
import torch

from raft_tpu_torch import DeviceResources, LogicError
from raft_tpu_torch.core.mdarray import ensure_tensor
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    (ROOT / "raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "raft_tpu"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def _c_entry_points():
    """name -> argument count of every ``extern "C"`` entry point in
    raft_tpu_torch/csrc."""
    import re

    found = {}
    for src in sorted((ROOT / "raft_tpu_torch" / "csrc").glob("*.cu")):
        for name, args in re.findall(
                r'extern "C" int (raft_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    return found


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point is bound with as many ctypes arguments as it
    declares (a missing one would shift every later argument)."""
    from raft_tpu_torch.ops import _cuda

    assert {n: len(a) for n, a in _cuda.SIGNATURES.items()} == \
        _c_entry_points()


def test_cuda_handle_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(LogicError, match="no CUDA device"):
        DeviceResources(device="cuda")


def test_cpu_handle_and_generator_replay():
    a, b = DeviceResources(seed=3, device="cpu"), DeviceResources(
        seed=3, device="cpu")
    assert a.device == torch.device("cpu")
    assert torch.equal(torch.rand(5, generator=a.generator),
                       torch.rand(5, generator=b.generator))


def test_ensure_tensor_moves_numpy_to_the_handle():
    res = DeviceResources(device="cpu")
    t = ensure_tensor(np.arange(6, dtype=np.float32).reshape(2, 3), res)
    assert isinstance(t, torch.Tensor) and t.shape == (2, 3)
    assert ensure_tensor(t, res) is t


def test_distance_type_values_match_the_reference():
    from raft_tpu.distance.types import DistanceType as JaxDistanceType

    assert {m.name: int(m) for m in DistanceType} == {
        m.name: int(m) for m in JaxDistanceType}


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_matches_the_reference(select_min):
    from raft_tpu.matrix.select_k import select_k as jax_select_k

    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 300)).astype(np.float32)
    payload = rng.integers(0, 10_000, size=x.shape).astype(np.int64)
    v, i = select_k(torch.from_numpy(x), 11,
                    in_idx=torch.from_numpy(payload), select_min=select_min)
    jv, ji = jax_select_k(x, 11, in_idx=payload, select_min=select_min)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_code_packing_matches_the_reference(pq_bits):
    from raft_tpu.neighbors import ivf_pq as jax_ivf_pq

    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, size=(9, 24)).astype(np.uint8)
    packed = ivf_pq._pack_codes(torch.from_numpy(codes), pq_bits)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_ivf_pq._pack_codes(codes, pq_bits)))
    np.testing.assert_array_equal(
        ivf_pq._unpack_codes(packed, 24, pq_bits).numpy(), codes)


def test_pack_and_append_lists():
    labels = torch.tensor([2, 0, 2, 1, 2])
    rows = torch.arange(10.0).reshape(5, 2)
    ids = torch.tensor([10, 11, 12, 13, 14])
    data, idx, sizes = ivf_flat._pack_lists(rows, labels, ids, 3, 4)
    assert sizes.tolist() == [1, 1, 3]
    assert idx.tolist() == [[11, -1, -1, -1], [13, -1, -1, -1],
                            [10, 12, 14, -1]]
    assert data[2, 1].tolist() == [4.0, 5.0]
    (data2,), idx2, sizes2 = ivf_flat._append_lists_multi(
        (data,), (torch.tensor([[-1.0, -2.0]]),), idx, sizes,
        torch.tensor([0]), torch.tensor([99]))
    assert sizes2.tolist() == [2, 1, 3] and idx2[0, 1] == 99
    assert data2[0, 1].tolist() == [-1.0, -2.0] and data[0, 1].sum() == 0


def test_select_clusters_matches_the_reference_exact_ranking():
    from raft_tpu.neighbors import ivf_flat as jax_ivf_flat

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(40, 16)).astype(np.float32)
    q = rng.normal(size=(25, 16)).astype(np.float32)
    got = ivf_flat._select_clusters(torch.from_numpy(centers),
                                    torch.from_numpy(q), 6,
                                    DistanceType.L2Expanded)
    want = jax_ivf_flat._select_clusters(centers, q, 6,
                                         DistanceType.L2Expanded, exact=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_match_the_reference_fields_and_defaults():
    from raft_tpu.neighbors import ivf_pq as jax_ivf_pq

    for ours, theirs in ((ivf_pq.IndexParams, jax_ivf_pq.IndexParams),
                         (ivf_pq.SearchParams, jax_ivf_pq.SearchParams)):
        mine = {f.name: f.default for f in ours.__dataclass_fields__.values()}
        ref = {f.name: f.default
               for f in theirs.__dataclass_fields__.values()}
        assert mine.keys() == ref.keys()
        for name in ("lut_dtype", "internal_distance_dtype"):
            mine.pop(name, None), ref.pop(name, None)
        assert mine == ref


@pytest.fixture(scope="module")
def tiny_index():
    rng = np.random.default_rng(2)
    db = rng.normal(size=(600, 32)).astype(np.float32)
    res = DeviceResources(seed=0, device="cpu")
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=8, pq_dim=8,
                                                 kmeans_n_iters=3), db)
    return res, index, db


def test_build_packs_every_row_once(tiny_index):
    _, index, db = tiny_index
    ids = index.list_indices.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(db.shape[0]))
    assert index.list_recon.dtype == torch.bfloat16
    assert index.list_recon.shape == (8, index.capacity, 32)
    assert index.capacity % 32 == 0 and index.capacity > int(
        index.list_sizes.max())


def test_extend_fast_path_appends_with_the_recon_cache(tiny_index):
    res, index, _ = tiny_index
    rng = np.random.default_rng(5)
    new = rng.normal(size=(3, 32)).astype(np.float32)
    out = ivf_pq.extend(res, index, new)
    assert out.capacity == index.capacity and out.size == index.size + 3
    assert out.generation == index.generation + 1
    slots = torch.nonzero(out.list_indices >= 600)
    assert slots.shape[0] == 3
    rebuilt = ivf_pq._decode_lists(out.codebooks, out.list_codes,
                                   out.pq_dim, out.pq_bits)
    for l, s in slots.tolist():
        assert torch.equal(out.list_recon[l, s], rebuilt[l, s])
    torch.testing.assert_close(out.list_recon_sq,
                               ivf_pq._recon_sq(out.list_recon))


def _jax_lut(index, q, k, n_probes, filter_words=None):
    """The JAX package's LUT scan (``_search_impl``) on the port's index
    arrays, at the exact coarse ranking."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import ivf_pq as jax_ivf_pq

    rd, ri = jax_ivf_pq._search_impl(
        index.centers.numpy(), index.codebooks.numpy(),
        index.list_codes.numpy(), index.list_indices.numpy(),
        index.rotation.numpy(), jnp.asarray(q), k, n_probes, index.metric,
        index.codebook_kind, "float32", pq_bits=index.pq_bits,
        exact_coarse=True, filter_words=filter_words)
    return np.asarray(rd), np.asarray(ri)


def _assert_tie_aware(d, i, rd, ri, rtol=1e-5):
    """Distances within ``rtol`` relative at every rank, the same
    exhausted ranks, and the same ids strictly inside each row's last
    kept distance (ids may differ only among ties at the edge)."""
    d, i = np.asarray(d), np.asarray(i)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_array_equal(i == -1, ~fin)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=rtol, atol=rtol)
    for prow, pids, rrow, rids in zip(d, i, rd, ri):
        f = np.isfinite(rrow)
        if f.any():
            edge = rrow[f][-1]
            margin = 1e-4 * (1.0 + abs(edge))
            assert (set(pids[np.isfinite(prow) & (prow < edge - margin)])
                    == set(rids[f & (rrow < edge - margin)]))


@pytest.mark.parametrize("change,item", [
    (dict(scan_mode="recon"), None),
    (dict(scan_mode="lut"), "LUT scan"),
    (dict(scan_mode="codes", per_probe_topk=129), "LUT scan"),
    (dict(use_reconstruction=True), None),
    (dict(use_reconstruction=False), "LUT scan"),
    # the ids the cases had when every non-fused mode was one deferred item
], ids=[f"change{i}-non-fused scan modes" for i in range(5)])
def test_search_modes_off_the_path_raise(tiny_index, change, item):
    """Each non-fused mode returns what the JAX function it resolves to
    returns on the same lists and probes: the LUT scan (``"lut"``,
    ``use_reconstruction=False``, and a codes search at kt > 128, which
    both of Kernel D's routes refuse) the JAX package's ``_search_impl``
    (fp32 LUT: distances within 1e-5 relative, ids tie-aware); the
    per-pair recon scan (Kernel G, ``scan_mode="recon"`` and
    ``use_reconstruction=True``) its recon twin."""
    res, index, db = tiny_index
    if item is not None:
        q, k = db[:2], 200
        d, i = ivf_pq.search(res, ivf_pq.SearchParams(**change), index, q,
                             k)
        rd, ri = _jax_lut(index, q, k, index.n_lists)
        _assert_tie_aware(d.numpy(), i.numpy(), rd, ri)
        return
    import jax.numpy as jnp
    from raft_tpu.neighbors import grouped
    from raft_tpu.neighbors import ivf_pq as jax_ivf_pq

    q, k = db[:2], 200
    d, i = ivf_pq.search(res, ivf_pq.SearchParams(**change), index, q, k)
    n_probes, cap, rot = index.n_lists, index.capacity, index.rot_dim
    probes = ivf_flat._select_clusters(
        index.centers, torch.from_numpy(q) @ index.rotation, n_probes,
        index.metric)
    ng, _ = grouped.group_capacity(2, n_probes, index.n_lists)
    block = grouped.block_size(ng, grouped.GROUP * cap * 8, cap * rot * 2,
                               grouped.GROUP * rot * 4)
    rd, ri = jax_ivf_pq._search_impl_recon_grouped(
        index.centers.numpy(),
        jnp.asarray(index.list_recon.float().numpy()).astype(jnp.bfloat16),
        index.list_recon_sq.numpy(), index.list_indices.numpy(),
        index.rotation.numpy(), jnp.asarray(q), jnp.asarray(probes.numpy()),
        k, index.metric, ng, block, use_pallas=True, pallas_interpret=True,
        kt=min(k, cap))
    rd, ri = np.asarray(rd), np.asarray(ri)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d.numpy()), fin)
    np.testing.assert_allclose(d.numpy()[fin], rd[fin], rtol=1e-4, atol=1e-4)
    overlap = np.mean([len(set(a) & set(b)) / k
                       for a, b in zip(i.numpy(), ri)])
    assert overlap >= 0.99, overlap


def test_filtered_and_ip_search_raise(tiny_index):
    """A filtered search runs (filters shipped): an all-admitting mask
    gives the unfiltered result.  InnerProduct IVF-PQ runs (shipped): the
    recon search returns what the JAX package's XLA twin returns on the
    same lists and probes, within 1e-4, ids tie-aware."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import grouped
    from raft_tpu.neighbors import ivf_pq as jax_ivf_pq

    res, index, db = tiny_index
    sp = ivf_pq.SearchParams()
    d, i = ivf_pq.search(res, sp, index, db[:2], 5,
                         filter=np.ones((2, 600), bool))
    d0, i0 = ivf_pq.search(res, sp, index, db[:2], 5)
    assert torch.equal(i, i0) and torch.equal(d, d0)
    ip = ivf_pq.Index(**{**index.__dict__,
                         "metric": DistanceType.InnerProduct})
    q, k = db[:2], 5
    d, i = ivf_pq.search(res, ivf_pq.SearchParams(scan_mode="recon"), ip,
                         q, k)
    probes = ivf_flat._select_clusters(
        ip.centers, torch.from_numpy(q) @ ip.rotation, 8, ip.metric)
    ng, _ = grouped.group_capacity(2, 8, ip.n_lists)
    cap, rot = ip.capacity, ip.rot_dim
    block = grouped.block_size(ng, grouped.GROUP * cap * 8, cap * rot * 2,
                               grouped.GROUP * rot * 4)
    rd, ri = jax_ivf_pq._search_impl_recon_grouped(
        ip.centers.numpy(),
        jnp.asarray(ip.list_recon.float().numpy()).astype(jnp.bfloat16),
        ip.list_recon_sq.numpy(), ip.list_indices.numpy(),
        ip.rotation.numpy(), jnp.asarray(q), jnp.asarray(probes.numpy()),
        k, ip.metric, ng, block, use_pallas=False, kt=k)
    rd, ri = np.asarray(rd), np.asarray(ri)
    assert np.all(np.diff(rd, axis=1) <= 0)        # largest first
    _assert_tie_aware(-d.numpy(), i.numpy(), -rd, ri, rtol=1e-4)


@pytest.mark.parametrize("change,item", [
    (dict(codebook_kind=ivf_pq.CodebookKind.PER_CLUSTER),
     "per-cluster books"),
    (dict(canary_queries=4), None),
])
def test_build_options_off_the_path_raise(change, item):
    """Options deferred before build and are stored: canaries (item None,
    deferred before the persistence slice) and per-cluster books (shipped
    since), one (book, pq_len) book a coarse list, which the JAX
    package's LUT scan reads as the port's does (fp32: within 1e-5, ids
    tie-aware)."""
    res = DeviceResources(device="cpu")
    db = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=2, **change), db)
    if item is None:
        assert index.canaries.n_queries == change["canary_queries"]
        return
    assert index.codebook_kind == ivf_pq.CodebookKind.PER_CLUSTER
    assert index.codebooks.shape == (2, 256, 4)
    d, i = ivf_pq.search(res, ivf_pq.SearchParams(n_probes=2,
                                                  scan_mode="lut"),
                         index, db[:5], 4)
    rd, ri = _jax_lut(index, db[:5], 4, 2)
    _assert_tie_aware(d.numpy(), i.numpy(), rd, ri)


def test_checkpoint_serialization_and_hierarchical_raise(tiny_index,
                                                         tmp_path):
    """Checkpointing and serialization (deferred before the persistence
    slice) work: a checkpointed build lists its two stages, and a saved
    index loads with the same arrays; the hierarchical fit raises only on
    what fit refuses."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans_types import KMeansBalancedParams
    from raft_tpu_torch.resilience import CheckpointManager

    res, index, db = tiny_index
    ckpt = str(tmp_path / "ckpt")
    ivf_pq.build(res, ivf_pq.IndexParams(n_lists=2), db, checkpoint=ckpt)
    assert CheckpointManager(ckpt).completed == ["kmeans", "codebooks"]
    path = str(tmp_path / "f")
    ivf_pq.save(res, path, index)
    buf = io.BytesIO()
    ivf_pq.serialize(res, buf, index)
    buf.seek(0)
    for loaded in (ivf_pq.load(res, path), ivf_pq.deserialize(res, buf)):
        for leaf in ("centers", "codebooks", "list_codes", "list_indices",
                     "list_recon"):
            assert torch.equal(getattr(loaded, leaf), getattr(index, leaf))
    # the hierarchical build is ported; it raises only on what fit refuses
    with pytest.raises(LogicError, match="n_clusters > n_samples"):
        kmeans_balanced.fit(res, KMeansBalancedParams(), db[:40], 41,
                            hierarchical=True)
    with pytest.raises(LogicError, match="L2Expanded / InnerProduct"):
        kmeans_balanced.fit(res, KMeansBalancedParams(
            metric=DistanceType.L2SqrtExpanded), db[:40], 8,
            hierarchical=True)


def test_padded_rotation_is_orthonormal_and_search_finds_self():
    """dim 30 with pq_dim 8 pads to rot_dim 32 through a seeded random
    rotation (rows orthonormal); every database row finds itself."""
    rng = np.random.default_rng(6)
    db = rng.normal(size=(500, 30)).astype(np.float32)
    res = DeviceResources(seed=0, device="cpu")
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=4, pq_dim=8,
                                                 kmeans_n_iters=3), db)
    r = index.rotation
    assert r.shape == (30, 32)
    torch.testing.assert_close(r @ r.T, torch.eye(30), rtol=0, atol=1e-5)
    _, found = ivf_pq.search(res, ivf_pq.SearchParams(n_probes=4), index,
                             db[:20], 5)
    assert (found[:, 0] == torch.arange(20, dtype=torch.int32)).float().mean() >= 0.9


@pytest.fixture(scope="module")
def tiny_flat():
    rng = np.random.default_rng(8)
    db = rng.normal(size=(600, 16)).astype(np.float32)
    res = DeviceResources(seed=0, device="cpu")
    return res, ivf_flat.build(res, ivf_flat.IndexParams(
        n_lists=8, kmeans_n_iters=3), db), db


def _flat_reloaded(res, index):
    buf = io.BytesIO()
    ivf_flat.serialize(res, buf, index)
    buf.seek(0)
    return ivf_flat.deserialize(res, buf)


def _flat_saved(res, index, path):
    ivf_flat.save(res, path, index)
    return path


@pytest.mark.parametrize("call,item", [
    (lambda res, index, db, d: ivf_flat.delete(res, index, [1]), None),
    (lambda res, index, db, d: ivf_flat.upsert(res, index, [1], db[:1]),
     None),
    (lambda res, index, db, d: ivf_flat.compact(res, index), None),
    (lambda res, index, db, d: ivf_flat.serialize(res, io.BytesIO(), index),
     None),
    (lambda res, index, db, d: _flat_reloaded(res, index), None),
    (lambda res, index, db, d: ivf_flat.save(res, str(d / "f"), index),
     None),
    (lambda res, index, db, d: ivf_flat.load(
        res, _flat_saved(res, index, str(d / "f"))), None),
    (lambda res, index, db, d: ivf_flat.search(
        res, ivf_flat.SearchParams(), index, db[:2], 5,
        filter=np.ones((2, 600), bool)), None),
    (lambda res, index, db, d: ivf_flat.build(
        res, ivf_flat.IndexParams(n_lists=2, canary_queries=4), db), None),
], ids=["delete", "upsert", "compact", "serialize", "deserialize", "save",
        "load", "filter", "canaries"])
def test_ivf_flat_paths_off_the_path_raise(tiny_flat, tmp_path, call, item):
    """Each IVF-Flat path this port has not reached raises
    NotImplementedError naming its ROADMAP item; the persistence paths
    (item None: serialization and canaries, and the filter and mutation
    paths, deferred before) complete."""
    if item is None:
        out = call(*tiny_flat, tmp_path)
        assert out is None or isinstance(out, (ivf_flat.Index, tuple))
        return
    with pytest.raises(NotImplementedError, match=item):
        call(*tiny_flat, tmp_path)
