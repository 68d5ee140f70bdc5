"""The port's ahead-of-time programs and bucket cache (``raft_tpu_torch.
core.aot``) and the static group count (``neighbors/grouped``) against the
JAX package, on the CPU.

- ``group_capacity`` / ``round_groups`` equal the JAX functions, and
  ``build_groups`` at a static ``n_groups`` equals the JAX ``build_groups``
  at the same count bit for bit (sentinel probes included); at any group
  size its first groups are the exact count's and the rest are empty,
  and ``groups_of`` (the scan routes' grouping) is that static grouping.
- Kernels B, G and F's grouped plain schedules (list-major and pair-group
  passes) give bit-equal distances and ids at the static count and at the
  exact one.
- Each exporter's artifact, loaded on the CPU, answers as the port's live
  search on the same index: ids equal, distances within 1e-5 of the
  live distance's scale (the same functions run).  A ``fused`` program
  runs ``ivf_pq``'s own Kernel B helper, where ``ivf_pq.search`` takes a
  codes-eligible index's ``fused`` to Kernel C (a difference by design).
- The artifact's arrays equal the JAX artifact's for the same index, array
  for array (the recon norms, which each package derives, within 1e-5
  relative); a JAX artifact (StableHLO) is refused with a typed error.
- ``ExecutableCache``: the JAX cases of ``tests/test_serving.py`` (batch
  sizes do not collide; the key includes k, n_probes, scan mode, rung and
  generation; a dead index never hits), on the port; a dead index's
  entries are dropped.
- ``export_fn`` / ``load_fn`` round trip through ``torch.export``.

Card tests (marked ``cuda``) capture each kind's bucket program in a CUDA
graph and hold the replay to the live program, bit for bit; they need
neither jax nor raft_tpu::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_aot.py
"""

import gc
import io

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from raft_tpu import DeviceResources as JaxResources
    from raft_tpu.core import aot as jax_aot
    from raft_tpu.neighbors import grouped as jax_grouped
    from raft_tpu.neighbors import ivf_flat as jf
    from raft_tpu.neighbors import ivf_pq as jp
except ImportError:   # a machine with the port only: the card tests run
    jnp = JaxResources = jax_aot = jax_grouped = jf = jp = None
from raft_tpu_torch import DeviceResources
from raft_tpu_torch.core import aot
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, grouped, ivf_flat, \
    ivf_pq
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import pq_group_scan as pgs

CPU = DeviceResources(device="cpu", seed=0)
N, DIM, N_LISTS, PQ_DIM, N_PROBES, K = 2000, 32, 16, 8, 4, 5
# ids equal; distances within this share of the row's live scale
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows():
    x = np.random.default_rng(0).standard_normal((N + 64, DIM)).astype(
        np.float32)
    return x[:N], x[N:]


def _need_jax():
    if jp is None:
        pytest.skip("needs jax and raft_tpu (the reference package)")


@pytest.fixture(scope="module")
def pq_pair(rows):
    """``(JAX index, port index)``: one ``raft_tpu`` build carried into the
    port through ``serialize``."""
    _need_jax()
    db, _ = rows
    jidx = jp.build(JaxResources(seed=0), jp.IndexParams(
        n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=4), db)
    buf = io.BytesIO()
    jp.serialize(JaxResources(seed=0), buf, jidx)
    return jidx, ivf_pq.deserialize(CPU, io.BytesIO(buf.getvalue()))


@pytest.fixture(scope="module")
def flat_pair(rows):
    _need_jax()
    db, _ = rows
    jidx = jf.build(JaxResources(seed=0), jf.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=4), db)
    buf = io.BytesIO()
    jf.serialize(JaxResources(seed=0), buf, jidx)
    return jidx, ivf_flat.deserialize(CPU, io.BytesIO(buf.getvalue()))


# ---------------------------------------------------------------------------
# the static group count
# ---------------------------------------------------------------------------

SHAPES = [(1, 3, 8), (5, 4, 8), (64, 8, 32), (300, 16, 20), (200, 96, 4096)]


@pytest.mark.parametrize("nq,n_probes,n_lists", SHAPES)
def test_group_capacity_equals_the_jax_function(nq, n_probes, n_lists):
    _need_jax()
    assert grouped.group_capacity(nq, n_probes, n_lists) == \
        jax_grouped.group_capacity(nq, n_probes, n_lists)
    for n in (0, 1, 255, 256, 257, 10_000):
        assert grouped.round_groups(n) == jax_grouped.round_groups(n)


@pytest.mark.parametrize("nq,n_probes,n_lists", [SHAPES[1], SHAPES[3]])
def test_static_build_groups_equals_the_jax_build_groups(nq, n_probes,
                                                         n_lists):
    """At the JAX package's static count the grouping is its grouping bit
    for bit, a sentinel probe (>= n_lists) in no group."""
    _need_jax()
    p = np.random.default_rng(nq).integers(0, n_lists, (nq, n_probes))
    p = p.astype(np.int32)
    p[0, -1] = n_lists
    cap = jax_grouped.group_capacity(nq, n_probes, n_lists)[0]
    jl, js = jax_grouped.build_groups(jnp.asarray(p), n_lists, cap)
    tl, ts = grouped.build_groups(torch.from_numpy(p), n_lists,
                                  n_groups=cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("group", [128, 64, 32, 16])
def test_static_groups_extend_the_exact_groups_with_empty_ones(group):
    p = torch.from_numpy(np.random.default_rng(group).integers(
        -1, 40, (70, 9)).astype(np.int32))
    cap, exact = grouped.group_capacity(70, 9, 39, group=group)
    assert exact
    el, es = grouped.build_groups(p, 39, group)
    sl, ss = grouped.build_groups(p, 39, group, cap)
    n = el.shape[0]
    assert cap >= n and sl.shape == (cap,) and ss.shape == (cap, group)
    assert torch.equal(sl[:n], el) and torch.equal(ss[:n], es)
    assert (ss[n:] == p.numel()).all() and (sl[n:] == 38).all()
    gl, sp = grouped.groups_of(p, 39, group)
    assert torch.equal(gl, sl) and torch.equal(sp, ss)


def _recon_inputs(port, q):
    qrot = torch.from_numpy(q) @ port.rotation
    probes = ivf_pq._select_clusters(port.centers, qrot, N_PROBES,
                                     port.metric)
    if port.list_recon_sq is None:
        port.list_recon_sq = ivf_pq._recon_sq(port.list_recon)
    return (qrot, port.centers.float(), probes, port.list_recon,
            port.list_recon_sq, port.list_indices)


def _flat_inputs(port, q):
    qf = torch.from_numpy(q)
    probes = ivf_flat._select_clusters(port.centers, qf, N_PROBES,
                                       port.metric)
    return qf, probes, port.list_data, ivf_flat._row_norms(
        port.list_data), port.list_indices


def _groups(probes, n_lists, group, static):
    """``build_groups`` at ``group_capacity``'s static count (``static``)
    or at the exact one."""
    n_groups = (grouped.group_capacity(*probes.shape, n_lists, group)[0]
                if static else None)
    return grouped.build_groups(probes, n_lists, group, n_groups)


def _grouped_run(name, pq, flat, q, static):
    """Kernel ``name``'s grouped plain schedule over groups at the static
    count (``static``) or the exact one."""
    if name in ("B", "G", "G pair-group"):
        qrot, cf, probes, recon, rsq, ids = _recon_inputs(pq, q)
        n_lists = cf.shape[0]
        group = 64 if name == "G pair-group" else 128
        gl, sp = _groups(probes, n_lists, group, static)
        if name == "B":
            return pgs.merge_pairs(*pgs.list_scan(
                qrot, cf, probes, gl, sp, recon, rsq, ids, K), K)
        if name == "G":
            return pgs.list_scan(qrot, cf, probes, gl, sp, recon, rsq, ids,
                                 K)
        return ps.recon_pair_list_scan(qrot, cf, probes, gl, sp, recon, rsq,
                                       ids, 80, group=64)
    qf, probes, data, dsq, ids = _flat_inputs(flat, q)
    group = 128 if name == "F" else 64
    gl, sp = _groups(probes, data.shape[0], group, static)
    if name == "F":
        return ps.flat_list_scan(qf, probes, gl, sp, data, dsq, ids, K)
    return ps.flat_pair_list_scan(qf, probes, gl, sp, data, dsq, ids, 80,
                                  group=64)


@pytest.mark.parametrize("name", ["B", "G", "G pair-group", "F",
                                  "F pair-group"])
def test_static_count_leaves_the_scans_bit_equal(pq_pair, flat_pair, rows,
                                                 name):
    _, q = rows
    vs, i_s = _grouped_run(name, pq_pair[1], flat_pair[1], q, True)
    ve, ie = _grouped_run(name, pq_pair[1], flat_pair[1], q, False)
    assert torch.equal(vs, ve) and torch.equal(i_s, ie)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def _close(d, i, rd, ri):
    d, i, rd, ri = (np.asarray(x) for x in (d, i, rd, ri))
    np.testing.assert_array_equal(i, ri)
    scale = np.abs(rd[np.isfinite(rd)]).max(initial=1.0)
    np.testing.assert_allclose(d, rd, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("mode", ["recon", "fused", "codes", "lut"])
def test_ivf_pq_artifact_answers_as_the_live_search(pq_pair, rows, mode):
    _, port = pq_pair
    _, q = rows
    buf = aot.export_ivf_pq_search(CPU, port, n_probes=N_PROBES, k=K,
                                   batch=8, scan_mode=mode)
    d, i = aot.load_search_fn(buf, device="cpu")(torch.from_numpy(q[:8]))
    # the artifact's modes are the JAX exporter's: fused / recon the recon
    # scans, codes / lut the lookup-table scan
    live = "lut" if mode in ("codes", "lut") else "recon"
    rd, ri = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode=live), port, q[:8], K)
    _close(d, i, rd, ri)


def test_served_fused_is_kernel_b_where_search_takes_kernel_c(pq_pair, rows):
    """By design (the JAX exporter's modes): a ``fused`` program runs
    ``ivf_pq``'s Kernel B helper over the baked recon cache, bit for bit,
    while ``ivf_pq.search(scan_mode="fused")`` resolves this codes-eligible
    index to the code scans (Kernel C)."""
    from raft_tpu_torch.utils import precision

    _, port = pq_pair
    qt = torch.from_numpy(rows[1][:8])
    d, i = aot.search_program(*aot._bake_ivf_pq(
        CPU, port, N_PROBES, K, 8, scan_mode="fused"))(qt)
    with precision.highest():
        qrot = qt.float() @ port.rotation
        probes = ivf_pq._select_clusters(port.centers, qrot, N_PROBES,
                                         port.metric)
        rd, ri = ivf_pq._search_fused_recon(port, qrot, probes, K, K)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert ivf_pq._resolve_mode(ivf_pq.SearchParams(scan_mode="fused"),
                                port) == ("codes", True)


def test_filtered_artifact_takes_the_words(pq_pair, rows):
    _, port = pq_pair
    _, q = rows
    mask = np.random.default_rng(1).random((8, N)) < 0.5
    from raft_tpu_torch.filters import SampleFilter
    f = SampleFilter.from_mask(torch.from_numpy(mask))
    nw = f.words.shape[1]
    g = aot.load_search_fn(aot.export_ivf_pq_search(
        CPU, port, n_probes=N_PROBES, k=K, batch=8, n_filter_words=nw),
        device="cpu")
    d, i = g(torch.from_numpy(q[:8]), f.words)
    rd, ri = ivf_pq.search(CPU, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="recon"), port, q[:8], K, filter=f)
    _close(d, i, rd, ri)
    with pytest.raises(RaftError):
        g(torch.from_numpy(q[:8]))


def test_ivf_flat_and_brute_force_artifacts(flat_pair, rows):
    _, port = flat_pair
    db, q = rows
    g = aot.load_search_fn(aot.export_ivf_flat_search(
        CPU, port, n_probes=N_PROBES, k=K, batch=4), device="cpu")
    d, i = g(torch.from_numpy(q[:4]))
    rd, ri = ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=N_PROBES),
                             port, q[:4], K)
    _close(d, i, rd, ri)
    g = aot.load_search_fn(aot.export_brute_force_knn(
        CPU, torch.from_numpy(db), k=K, batch=4), device="cpu")
    d, i = g(torch.from_numpy(q[:4]))
    rd, ri = brute_force.knn(CPU, torch.from_numpy(db), q[:4], K)
    _close(d, i, rd, ri)


def test_cagra_artifact_answers_as_the_live_walk(rows):
    db, q = rows
    res = DeviceResources(device="cpu", seed=0)
    index = cagra.build(res, cagra.IndexParams(
        intermediate_graph_degree=16, graph_degree=8), db[:1000])
    sp = cagra.SearchParams(itopk_size=32, search_width=2)
    rd, ri = cagra.search(res, sp, index, q[:4], K)
    g = aot.load_search_fn(aot.export_cagra_search(
        res, index, k=K, batch=4, itopk=32, search_width=2), device="cpu")
    d, i = g(torch.from_numpy(q[:4]))
    _close(d, i, rd, ri)


def _jax_arrays(buf):
    """A JAX artifact's baked arrays (bf16 as the uint16 view)."""
    stream = io.BytesIO(buf.getvalue())
    assert stream.read(len(aot._MAGIC)) == aot._MAGIC
    stream.read(int.from_bytes(stream.read(8), "little"))
    with np.load(stream, allow_pickle=False) as payload:
        n = len(payload["dtypes"])
        return [payload[f"a{j}"] for j in range(n)], list(payload["dtypes"])


@pytest.mark.parametrize("kind", ["recon", "codes", "ivf_flat",
                                  "brute_force"])
def test_artifact_arrays_equal_the_jax_artifacts(pq_pair, flat_pair, rows,
                                                 kind):
    """Array for array, in the JAX order; the recon norms, derived by each
    package from the same bf16 rows, within 1e-5 relative."""
    jres = JaxResources(seed=0)
    db, _ = rows
    if kind in ("recon", "codes"):
        jidx, port = pq_pair
        jbuf = jax_aot.export_ivf_pq_search(jres, jidx, n_probes=N_PROBES,
                                            k=K, batch=4, scan_mode=kind)
        tbuf = aot.export_ivf_pq_search(CPU, port, n_probes=N_PROBES, k=K,
                                        batch=4, scan_mode=kind)
    elif kind == "ivf_flat":
        jidx, port = flat_pair
        jbuf = jax_aot.export_ivf_flat_search(jres, jidx, n_probes=N_PROBES,
                                              k=K, batch=4)
        tbuf = aot.export_ivf_flat_search(CPU, port, n_probes=N_PROBES,
                                          k=K, batch=4)
    else:
        jbuf = jax_aot.export_brute_force_knn(jres, jnp.asarray(db), k=K,
                                              batch=4)
        tbuf = aot.export_brute_force_knn(CPU, torch.from_numpy(db), k=K,
                                          batch=4)
    ja, jd = _jax_arrays(jbuf)
    program, ta = aot.read_artifact(tbuf)
    assert program["dtypes"] == jd
    assert len(ta) == len(ja)
    for j, (a, b) in enumerate(zip(ta, ja)):
        assert a.shape == b.shape and a.dtype == b.dtype, j
        if kind == "recon" and j == 2:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def test_a_jax_artifact_is_refused_naming_its_stablehlo(pq_pair):
    jidx, _ = pq_pair
    jbuf = jax_aot.export_ivf_pq_search(JaxResources(seed=0), jidx,
                                        n_probes=N_PROBES, k=K, batch=2)
    with pytest.raises(aot.AotFormatError, match="StableHLO"):
        aot.load_search_fn(jbuf, device="cpu")
    with pytest.raises(aot.AotFormatError, match="not a raft_tpu"):
        aot.load_search_fn(io.BytesIO(b"junk" * 8), device="cpu")


def test_export_fn_round_trips_through_torch_export():
    def fn(x, y):
        return torch.topk(x @ y, 3, dim=1)

    x, y = torch.randn(4, 5), torch.randn(5, 6)
    g = aot.load_fn(aot.export_fn(fn, (x, y)))
    x2, y2 = torch.randn(4, 5), torch.randn(5, 6)
    out, ref = g(x2, y2), fn(x2, y2)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("name", ["export_ivf_pq_routed_search",
                                  "warm_write_router"])
def test_routed_exports_are_item_7_stand_ins(name):
    with pytest.raises(NotImplementedError, match="item 7"):
        getattr(aot, name)(None, None)


# ---------------------------------------------------------------------------
# the executable cache (tests/test_serving.py:396-466 on the port)
# ---------------------------------------------------------------------------

def test_cache_round_trip_per_bucket(pq_pair, rows):
    _, port = pq_pair
    _, q = rows
    cache = aot.ExecutableCache()
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon")
    for batch in (1, 2, 4, 8):
        g = cache.get("ivf_pq", CPU, port, batch=batch, k=K,
                      n_probes=N_PROBES, scan_mode="recon")
        d, i = g(torch.from_numpy(q[:batch]))
        _close(d, i, *ivf_pq.search(CPU, sp, port, q[:batch], K))
    assert len(cache) == 4 and cache.misses == 4 and cache.captures == 0


def test_cache_batch_sizes_do_not_collide(pq_pair, rows):
    _, port = pq_pair
    q = torch.from_numpy(rows[1])
    cache = aot.ExecutableCache()
    g2 = cache.get("ivf_pq", CPU, port, batch=2, k=K, n_probes=N_PROBES,
                   scan_mode="recon")
    g4 = cache.get("ivf_pq", CPU, port, batch=4, k=K, n_probes=N_PROBES,
                   scan_mode="recon")
    assert g2 is not g4
    assert g2(q[:2])[0].shape == (2, K) and g4(q[:4])[0].shape == (4, K)
    with pytest.raises(RaftError):
        g2(q[:4])
    assert cache.get("ivf_pq", CPU, port, batch=2, k=K, n_probes=N_PROBES,
                     scan_mode="recon") is g2
    assert cache.hits == 1


def test_cache_key_includes_k_probes_mode_rung_and_generation(pq_pair):
    _, port = pq_pair
    cache = aot.ExecutableCache()
    base = dict(batch=2, k=K, n_probes=N_PROBES, scan_mode="recon")
    fns = [cache.get("ivf_pq", CPU, port, **dict(base, **change))
           for change in ({}, {"k": 3}, {"n_probes": 2},
                          {"scan_mode": "fused"}, {"scan_mode": "lut"},
                          {"rung": 1})]
    assert len({id(f) for f in fns}) == len(fns)
    gen0 = port.generation
    try:
        port.generation = gen0 + 1
        b = cache.get("ivf_pq", CPU, port, **base)
        assert b is not fns[0]
        assert cache.get("ivf_pq", CPU, port, **base) is b
    finally:
        port.generation = gen0


def test_cache_dead_index_never_hits(pq_pair):
    _, port = pq_pair
    cache = aot.ExecutableCache()
    other = ivf_pq.deserialize(CPU, _serialized(port))
    g1 = cache.get("ivf_pq", CPU, port, batch=2, k=K, n_probes=N_PROBES,
                   scan_mode="recon")
    key = next(iter(cache._entries))
    # an id() recycled: another index object under the same key
    cache._entries[(key[0], id(other)) + key[2:]] = cache._entries[key]
    g2 = cache.get("ivf_pq", CPU, other, batch=2, k=K, n_probes=N_PROBES,
                   scan_mode="recon")
    assert g2 is not g1


def test_cache_drops_a_dead_index_entries(pq_pair):
    """An index's entries (and on the card their graphs) go with it."""
    _, port = pq_pair
    cache = aot.ExecutableCache()
    other = ivf_pq.deserialize(CPU, _serialized(port))
    db = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, DIM)).astype(np.float32))
    for b in (1, 2):
        cache.get("ivf_pq", CPU, other, batch=b, k=K, n_probes=N_PROBES,
                  scan_mode="recon")
        cache.get("brute_force", CPU, db, batch=b, k=K)
    cache.get("ivf_pq", CPU, port, batch=1, k=K, n_probes=N_PROBES,
              scan_mode="recon")
    assert len(cache) == 5
    del other, db
    gc.collect()
    assert len(cache) == 1


def _serialized(index):
    buf = io.BytesIO()
    ivf_pq.serialize(CPU, buf, index)
    buf.seek(0)
    return buf


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def card_data(dev):
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((20_000, 64)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(dev)
    return db, q


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_pq fused", "ivf_pq recon",
                                  "ivf_pq lut", "ivf_pq ip", "ivf_flat",
                                  "brute_force", "cagra"])
def test_each_kind_is_captured_and_replays_its_live_program(card_data,
                                                            kind):
    """One capture a bucket; the replay equals the same program run live,
    ids and distances bit for bit (InnerProduct: the composition captured
    at the static group count, live at the exact one)."""
    from raft_tpu_torch.distance.types import DistanceType

    db, q = card_data
    res = DeviceResources(seed=0)
    name, _, mode = kind.partition(" ")
    if name == "ivf_pq":
        metric = DistanceType.L2Expanded
        if mode == "ip":
            metric, mode = DistanceType.InnerProduct, "recon"
        index = ivf_pq.build(res, ivf_pq.IndexParams(
            n_lists=64, pq_dim=32, metric=metric), db)
        bake = lambda b: aot._bake_ivf_pq(res, index, 16, K, b,  # noqa
                                          scan_mode=mode)
        kw = dict(n_probes=16, scan_mode=mode)
    elif name == "ivf_flat":
        index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=64), db)
        bake = lambda b: aot._bake_ivf_flat(res, index, 16, K, b)  # noqa
        kw = dict(n_probes=16)
    elif name == "brute_force":
        index = db
        bake = lambda b: aot._bake_brute_force(res, index, K, b)  # noqa
        kw = {}
    else:
        index = cagra.build(res, cagra.IndexParams(
            intermediate_graph_degree=32, graph_degree=16), db)
        bake = lambda b: aot._bake_cagra(res, index, K, b)  # noqa
        kw = dict(itopk=64)
    cache = aot.ExecutableCache()
    pool = aot.GraphPool()
    for b in (1, 8, 64):
        g = cache.get(name, res, index, batch=b, k=K, pool=pool, **kw)
        assert hasattr(g, "graph")
        live = aot.search_program(*bake(b))
        d, i = g(q[:b])
        rd, ri = live(q[:b])
        assert torch.equal(i, ri) and torch.equal(d, rd), b
    assert cache.captures == 3 and pool.bytes() != 0
