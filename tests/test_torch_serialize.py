"""raft_tpu_torch persistence against the JAX package, on the CPU: the
index streams byte for byte, files crossing between the packages in both
directions, the version windows, and the output types.

Indexes are built small by ``raft_tpu`` on the CPU and carried into the
port with ``index_from_numpy(..., device="cpu")``; ``serialize`` of the
two must give the same bytes (IVF-Flat at float32, float16, int8 and
uint8; IVF-PQ and CAGRA at float32; each with and without canaries).  A
file written by either package's ``save`` loads in the other and searches
to the writer's result on the same queries, at the tolerances the
existing parity tests hold: IVF-Flat distances within 1e-5 of ‖q‖² +
max ‖x‖² and ids equal strictly inside each row's k-th distance; IVF-PQ
ids on >= 0.99 of the slots and distances within 1e-4; CAGRA (the JAX
walk cache attached to the loaded index) ids on >= 0.99 of the slots and
distances within 1e-5.  Card tests (marked ``cuda``) hold save -> load ->
search on the card to the in-memory index's result; they skip without a
CUDA device, and need neither jax nor raft_tpu, so they run where only
the port is installed::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_serialize.py
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from raft_tpu import DeviceResources as JaxResources
    from raft_tpu import config as jax_config
    from raft_tpu.core import serialize as jax_ser
    from raft_tpu.integrity import canary as jax_canary
    from raft_tpu.neighbors import cagra as jc
    from raft_tpu.neighbors import ivf_flat as jf
    from raft_tpu.neighbors import ivf_pq as jp
except ImportError:   # a machine with the port only: the card tests run
    jnp = JaxResources = jax_config = jax_ser = jax_canary = None
    jc = jf = jp = None
from raft_tpu_torch import DeviceResources, config
from raft_tpu_torch.core import outputs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.integrity import canary
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

CPU = DeviceResources(device="cpu")
K = 10
FLAT_LEAVES = ("centers", "list_data", "list_indices", "list_sizes")
PQ_LEAVES = ("centers", "codebooks", "list_codes", "list_indices",
             "list_sizes", "rotation")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (a parallel run oversubscribes
    the cores otherwise); results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sift_like(n, dim=32, seed=0):
    """bench.py's generator at a small size: a 16-d latent mapped to dim,
    plus 5% noise."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 16)).astype(np.float32)
    a = rng.normal(size=(16, dim)).astype(np.float32) / np.float32(4.0)
    x = z @ a
    return (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)


def _as(x, dtype):
    """The data in ``dtype``: integer types scaled to use their range."""
    if np.dtype(dtype).kind in "iu":
        x = x / np.abs(x).max() * 100.0
        if np.dtype(dtype).kind == "u":
            x = x + 120.0
        return np.round(x).astype(dtype)
    return x.astype(dtype)


@pytest.fixture(scope="module")
def data():
    x = _sift_like(1240, seed=3)
    return x[:1200], x[1200:]


def _port_canaries(cs):
    return None if cs is None else canary.CanarySet(
        queries=np.asarray(cs.queries), gt_ids=np.asarray(cs.gt_ids),
        floor=cs.floor, build_recall=cs.build_recall)


def _carry(kind, index):
    """The port's copy of a ``raft_tpu`` index, canaries included."""
    if kind == "ivf_flat":
        out = ivf_flat.index_from_numpy(
            {n: np.asarray(getattr(index, n)) for n in FLAT_LEAVES},
            metric=index.metric, adaptive_centers=index.adaptive_centers,
            device="cpu")
    elif kind == "ivf_pq":
        out = ivf_pq.index_from_numpy(
            {n: np.asarray(getattr(index, n)) for n in PQ_LEAVES},
            metric=index.metric, pq_bits=index.pq_bits, pq_dim=index.pq_dim,
            group_est=index.group_est, device="cpu")
    else:
        out = cagra.index_from_numpy(np.asarray(index.dataset),
                                     np.asarray(index.graph), index.metric,
                                     device="cpu")
    out.canaries = _port_canaries(index.canaries)
    return out


MODULES = {"ivf_flat": (jf, ivf_flat), "ivf_pq": (jp, ivf_pq),
           "cagra": (jc, cagra)}


def _jax_build(kind, x, canaries):
    extra = dict(canary_queries=8, canary_k=5) if canaries else {}
    res = JaxResources(seed=5)
    if kind == "ivf_flat":
        return jf.build(res, jf.IndexParams(n_lists=8, kmeans_n_iters=4,
                                            **extra), x)
    if kind == "ivf_pq":
        return jp.build(res, jp.IndexParams(n_lists=8, pq_dim=8,
                                            kmeans_n_iters=4, **extra), x)
    return jc.build(res, jc.IndexParams(intermediate_graph_degree=16,
                                        graph_degree=8, **extra), x)


def _bytes(module, res, index):
    buf = io.BytesIO()
    module.serialize(res, buf, index)
    return buf.getvalue()


CASES = [("ivf_flat", "float32", False), ("ivf_flat", "float16", False),
         ("ivf_flat", "int8", False), ("ivf_flat", "uint8", False),
         ("ivf_flat", "float32", True), ("ivf_pq", "float32", False),
         ("ivf_pq", "float32", True), ("cagra", "float32", False),
         ("cagra", "float16", False), ("cagra", "float32", True)]


@pytest.fixture(scope="module")
def built(data):
    db, _ = data
    return {case: _jax_build(case[0], _as(db, case[1]), case[2])
            for case in CASES}


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_serialize_is_byte_equal_across_packages(built, case):
    """``serialize`` of a ``raft_tpu`` index and of the port's copy of it
    give the same bytes; the port reads the JAX stream and writes it back
    unchanged, its rows upcast exactly to float32."""
    kind, dtype, _ = case
    jmod, tmod = MODULES[kind]
    index = built[case]
    ref = _bytes(jmod, None, index)
    assert _bytes(tmod, CPU, _carry(kind, index)) == ref
    back = tmod.deserialize(CPU, io.BytesIO(ref))
    assert _bytes(tmod, CPU, back) == ref
    if kind != "ivf_pq":
        rows = back.list_data if kind == "ivf_flat" else back.dataset
        stored = index.list_data if kind == "ivf_flat" else index.dataset
        assert rows.dtype == torch.float32
        assert back.data_dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            rows.numpy(), np.asarray(stored).astype(np.float32))
    assert (back.canaries is None) == (index.canaries is None)


@pytest.fixture(scope="module")
def f32(built):
    return {kind: built[(kind, "float32", False)] for kind in MODULES}


def _flat_same(pd, pi, rd, ri, scale):
    atol = 1e-5 * scale
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=atol)
    for prow, pids, rrow, rids in zip(pd, pi, rd, ri):
        edge = rrow[np.isfinite(rrow)][-1]
        assert set(pids[prow < edge - atol]) == set(rids[rrow < edge - atol])


def _pq_same(pd, pi, rd, ri):
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(pi, ri)]) >= 0.99
    np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1e-4)


def _walk_same(pd, pi, rd, ri):
    assert (pi == ri).mean() >= 0.99
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)


def _jax_search(kind, index, q):
    res = JaxResources(seed=0)
    if kind == "ivf_flat":
        return jf.search(res, jf.SearchParams(n_probes=4, exact_coarse=True),
                         index, jnp.asarray(q), K)
    if kind == "ivf_pq":
        return jp.search(res, jp.SearchParams(n_probes=4, exact_coarse=True),
                         index, jnp.asarray(q), K)
    return jc.search(res, jc.SearchParams(itopk_size=32, search_width=2,
                                          entry_points=256),
                     index, jnp.asarray(q), K)


def _port_search(kind, index, q, jax_index=None):
    if kind == "ivf_flat":
        return ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=4), index,
                               q, K)
    if kind == "ivf_pq":
        return ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=4), index, q,
                             K)
    # the entry set is a random draw: search with the JAX index's walk
    # cache attached (its projection and entry ids)
    (pdim, _), = list(jax_index._walk_tables)
    _, proj, _ = jax_index._walk_tables[(pdim, False)]
    _, _, eids = jax_index._walk_entries[(pdim, 256)]
    index = cagra.attach_walk_cache(index, np.asarray(proj),
                                    np.asarray(eids))
    return cagra.search(CPU, cagra.SearchParams(
        itopk_size=32, search_width=2, entry_points=256), index, q, K)


def _assert_same_search(kind, ours, ref, q, index):
    pd, pi = (t.numpy() for t in ours)
    rd, ri = (np.asarray(t) for t in ref)
    if kind == "ivf_flat":
        scale = float((q * q).sum(1).max()
                      + (np.asarray(index.list_data) ** 2).sum(-1).max())
        _flat_same(pd, pi, rd, ri, scale)
    elif kind == "ivf_pq":
        _pq_same(pd, pi, rd, ri)
    else:
        _walk_same(pd, pi, rd, ri)


@pytest.mark.parametrize("kind", list(MODULES))
def test_a_file_raft_tpu_saved_loads_and_searches_alike(data, f32, kind,
                                                        tmp_path):
    """``raft_tpu.<kind>.save`` -> the port's ``load`` -> search: the JAX
    index's result on the same queries."""
    _, q = data
    jmod, tmod = MODULES[kind]
    index = f32[kind]
    path = str(tmp_path / f"{kind}.idx")
    jmod.save(JaxResources(seed=0), path, index)
    loaded = tmod.load(CPU, path)
    ref = _jax_search(kind, index, q)
    _assert_same_search(kind, _port_search(kind, loaded, q, index), ref, q,
                        index)


@pytest.mark.parametrize("kind", list(MODULES))
def test_a_file_the_port_saved_loads_in_raft_tpu_and_searches_alike(
        data, kind, tmp_path):
    """A port-built index saved by the port -> ``raft_tpu.<kind>.load`` ->
    the JAX search gives the port's result on the same queries."""
    db, q = data
    _, tmod = MODULES[kind]
    res = DeviceResources(seed=2, device="cpu")
    if kind == "ivf_flat":
        index = ivf_flat.build(res, ivf_flat.IndexParams(
            n_lists=8, kmeans_n_iters=4), db)
    elif kind == "ivf_pq":
        index = ivf_pq.build(res, ivf_pq.IndexParams(
            n_lists=8, pq_dim=8, kmeans_n_iters=4), db)
    else:
        index = cagra.build(res, cagra.IndexParams(
            intermediate_graph_degree=16, graph_degree=8), db)
    path = str(tmp_path / f"{kind}.idx")
    tmod.save(res, path, index)
    loaded = MODULES[kind][0].load(JaxResources(seed=0), path)
    ref = _jax_search(kind, loaded, q)
    _assert_same_search(kind, _port_search(kind, index, q, loaded), ref, q,
                        loaded)


# ---------------------------------------------------------------------------
# version windows
# ---------------------------------------------------------------------------

def _stream(kind, index, version, *, codebook_kind=0):
    """A stream of ``index`` at serialization ``version`` (built record by
    record, as the writer of that version laid it out)."""
    body = io.BytesIO()
    scalar = lambda v: jax_ser.serialize_scalar(None, body, v)  # noqa: E731
    scalar(np.int32(version))
    scalar(np.int32(index.metric))
    if kind == "ivf_flat":
        scalar(np.int32(index.adaptive_centers))
        arrays, canary_from = FLAT_LEAVES, 2
    elif kind == "ivf_pq":
        for v in (codebook_kind, index.pq_bits, index.pq_dim):
            scalar(np.int32(v))
        if version >= 4:
            scalar(np.float64(0.75))
        arrays, canary_from = PQ_LEAVES, 3
    else:
        arrays, canary_from = ("dataset", "graph"), 2
    for name in arrays:
        jax_ser.serialize_mdspan(None, body, np.asarray(getattr(index, name)))
    if version >= canary_from:
        jax_canary.to_stream(None, body, None)
    out = io.BytesIO()
    jax_ser.write_envelope(out, body.getvalue())
    return out.getvalue()


WINDOWS = {"ivf_flat": (1, 2), "ivf_pq": (2, 4), "cagra": (1, 2)}
VERSIONS = [(kind, v) for kind, (lo, hi) in WINDOWS.items()
            for v in range(lo - 1, hi + 2)]


@pytest.mark.parametrize("kind,version", VERSIONS,
                         ids=[f"{k}-v{v}" for k, v in VERSIONS])
def test_version_window_matches_the_reference(f32, kind, version):
    """Inside the window both packages read the stream to the same arrays
    (an IVF-PQ stream before v4 loads uncalibrated, group_est 0.0);
    outside it both raise ValueError with the same message."""
    jmod, tmod = MODULES[kind]
    raw = _stream(kind, f32[kind], version)
    lo, hi = WINDOWS[kind]
    if not lo <= version <= hi:
        with pytest.raises(ValueError) as ref:
            jmod.deserialize(JaxResources(seed=0), io.BytesIO(raw))
        with pytest.raises(ValueError) as ours:
            tmod.deserialize(CPU, io.BytesIO(raw))
        assert str(ours.value) == str(ref.value)
        assert "serialization version mismatch" in str(ours.value)
        return
    ref = jmod.deserialize(JaxResources(seed=0), io.BytesIO(raw))
    ours = tmod.deserialize(CPU, io.BytesIO(raw))
    names = {"ivf_flat": FLAT_LEAVES, "ivf_pq": PQ_LEAVES,
             "cagra": ("dataset", "graph")}[kind]
    for name in names:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert ours.canaries is None and ref.canaries is None
    if kind == "ivf_pq":
        assert ours.group_est == ref.group_est == (0.75 if version >= 4
                                                   else 0.0)
        assert ours.pq_dim == ref.pq_dim


def test_per_cluster_file_raises_not_ported(f32):
    """A file holding per-cluster books is refused, never loaded half
    right."""
    raw = _stream("ivf_pq", f32["ivf_pq"], 4, codebook_kind=1)
    with pytest.raises(NotImplementedError, match="per-cluster books"):
        ivf_pq.deserialize(CPU, io.BytesIO(raw))


@pytest.mark.parametrize("cache", [True, False])
def test_ivf_pq_load_rederives_the_recon_cache(f32, tmp_path, cache):
    """``cache_reconstructions=True`` decodes the recon cache again, equal
    to the JAX index's; False leaves the index without one."""
    index = f32["ivf_pq"]
    path = str(tmp_path / "pq.idx")
    jp.save(JaxResources(seed=0), path, index)
    loaded = ivf_pq.load(CPU, path, cache_reconstructions=cache)
    if not cache:
        assert loaded.list_recon is None
        return
    np.testing.assert_array_equal(
        loaded.list_recon.float().numpy(),
        np.asarray(index.list_recon).astype(np.float32))


def test_envelope_header_is_the_reference_layout():
    """magic RTIE | u16 version 1 | u64 payload bytes | u32 CRC32, then the
    payload; the same bytes from both packages."""
    payload = b"persistence" * 7
    ours, ref = io.BytesIO(), io.BytesIO()
    ser.write_envelope(ours, payload)
    jax_ser.write_envelope(ref, payload)
    assert ours.getvalue() == ref.getvalue()
    assert ours.getvalue()[:18] == struct.pack(
        "<4sHQI", b"RTIE", 1, len(payload), zlib.crc32(payload))


@pytest.mark.parametrize("value", [np.int32(-3), np.float64(0.25),
                                   np.uint8(200), np.int64(1 << 40)],
                         ids=["i4", "f8", "u1", "i8"])
def test_scalar_records_are_byte_equal(value):
    ours, ref = io.BytesIO(), io.BytesIO()
    ser.serialize_scalar(None, ours, value)
    jax_ser.serialize_scalar(None, ref, value)
    assert ours.getvalue() == ref.getvalue()
    ours.seek(0)
    assert ser.deserialize_scalar(None, ours) == value


def test_a_transposed_tensor_is_written_c_ordered():
    """A tensor view is written as its C-contiguous copy, the header the
    JAX package writes for the same array."""
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    ours, ref = io.BytesIO(), io.BytesIO()
    ser.serialize_mdspan(None, ours, torch.from_numpy(base).T)
    jax_ser.serialize_mdspan(None, ref, jnp.asarray(base).T)
    assert ours.getvalue() == ref.getvalue()
    assert b"'fortran_order': False" in ours.getvalue()


# ---------------------------------------------------------------------------
# output types (config.set_output_as)
# ---------------------------------------------------------------------------

@pytest.fixture
def output_as():
    yield config.set_output_as
    config.set_output_as("torch")


def _decorated_calls(db, q):
    """The port's public functions the JAX package decorates with
    ``auto_convert_output``, each called on small inputs."""
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import KMeansParams
    from raft_tpu_torch.distance import (distance, fused_l2_nn,
                                         fused_l2_nn_min_reduce,
                                         pairwise_distance)
    from raft_tpu_torch.matrix import merge_topk, select_k
    from raft_tpu_torch.neighbors import refine

    x, y = torch.from_numpy(db[:40]), torch.from_numpy(db[40:60])
    d = torch.from_numpy(q[:4] @ db[:30].T)
    kp = KMeansParams(n_clusters=4, max_iter=3)
    c = x[:4]
    flat = ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=4), db[:400])
    pq = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=4, pq_dim=8), db[:400])
    graph = cagra.build(CPU, cagra.IndexParams(intermediate_graph_degree=16,
                                               graph_degree=8), db[:400])
    cand = torch.arange(20, dtype=torch.int32).repeat(4, 1)
    return {
        "pairwise_distance": lambda: pairwise_distance(x, y),
        "distance": lambda: distance(x, y),
        "fused_l2_nn": lambda: fused_l2_nn(x, y),
        "fused_l2_nn_min_reduce": lambda: fused_l2_nn_min_reduce(x, y),
        "select_k": lambda: select_k(d, 3),
        "merge_topk": lambda: merge_topk(d[:, :3], cand[:, :3], d[:, 3:6],
                                         cand[:, 3:6]),
        "kmeans.fit": lambda: kmeans.fit(CPU, kp, x),
        "kmeans.predict": lambda: kmeans.predict(CPU, kp, x, c),
        "kmeans.fit_predict": lambda: kmeans.fit_predict(CPU, kp, x),
        "kmeans.transform": lambda: kmeans.transform(CPU, kp, x, c),
        "ivf_flat.search": lambda: ivf_flat.search(
            CPU, ivf_flat.SearchParams(n_probes=2), flat, q[:4], 5),
        "ivf_pq.search": lambda: ivf_pq.search(
            CPU, ivf_pq.SearchParams(n_probes=2), pq, q[:4], 5),
        "cagra.search": lambda: cagra.search(
            CPU, cagra.SearchParams(), graph, q[:4], 5),
        "refine": lambda: refine(CPU, db, q[:4], cand, 5),
        "brute_force.knn": lambda: brute_force.knn(CPU, db, q[:4], 5),
    }


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for v in out for leaf in _leaves(v)]
    return [out]


class _Boxed:
    """What the callable output type below makes of a tensor."""

    def __init__(self, t):
        self.t = t


@pytest.mark.parametrize("conf,kind", [
    ("torch", torch.Tensor), ("numpy", np.ndarray), (_Boxed, _Boxed)],
    ids=["torch", "numpy", "callable"])
def test_output_as_converts_every_decorated_function(data, output_as, conf,
                                                     kind):
    """Every decorated function returns the configured type in each of its
    array leaves (ints such as ``n_iter`` pass through), the library's
    own compositions staying in tensors underneath."""
    db, q = data
    calls = _decorated_calls(db, q)
    assert len(calls) == 15
    output_as(conf)
    for name, call in calls.items():
        arrays = [leaf for leaf in _leaves(call())
                  if not isinstance(leaf, (int, float))]
        assert arrays, name
        for leaf in arrays:
            assert isinstance(leaf, kind), (name, type(leaf))
    assert outputs.raw(ivf_pq.search) is not ivf_pq.search


def test_output_as_rejects_what_it_cannot_honour(output_as):
    """The port's types are torch (the default) and numpy, plus a
    callable; "jax" would need jax, and raises as any unknown name does
    (the JAX package takes it and refuses "cupy" the same way)."""
    assert config.SUPPORTED_OUTPUT_TYPES == ["torch", "numpy"]
    assert config.get_output_as() == "torch"
    for bad in ("jax", "cupy"):
        with pytest.raises(ValueError, match="Unsupported output option"):
            output_as(bad)
    with pytest.raises(ValueError):
        jax_config.set_output_as("cupy")
    assert config.get_output_as() == "torch"


def test_output_as_preserves_named_tuples(output_as):
    import collections

    Pair = collections.namedtuple("Pair", "dist ids")

    @outputs.auto_convert_output
    def pair():
        return Pair(torch.zeros(2), [torch.ones(1), 3])

    output_as("numpy")
    out = pair()
    assert isinstance(out, Pair) and isinstance(out.dist, np.ndarray)
    assert isinstance(out.ids[0], np.ndarray) and out.ids[1] == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(MODULES))
def test_save_load_search_on_the_card_equals_the_built_index(dev, data, kind,
                                                             tmp_path):
    """On the card, a saved and loaded index searches to the in-memory
    index's ids and distances (CAGRA: two fresh index objects of the same
    dataset and graph, each first searched on a handle of the same
    seed)."""
    db, q = data
    res = DeviceResources(seed=0)
    _, tmod = MODULES[kind]
    if kind == "ivf_flat":
        index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=8), db)
        sp = ivf_flat.SearchParams(n_probes=4)
    elif kind == "ivf_pq":
        index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=8, pq_dim=8),
                             db)
        sp = ivf_pq.SearchParams(n_probes=4)
    else:
        index = cagra.build(res, cagra.IndexParams(
            intermediate_graph_degree=16, graph_degree=8), db)
        sp = cagra.SearchParams(itopk_size=32, search_width=2)
    path = str(tmp_path / f"{kind}.idx")
    tmod.save(res, path, index)
    loaded = tmod.load(res, path)
    assert loaded.list_indices.device == dev if kind != "cagra" else \
        loaded.graph.device == dev
    if kind == "cagra":
        index = cagra.Index(dataset=index.dataset, graph=index.graph)
        ref = cagra.search(DeviceResources(seed=9), sp, index, q, K)
        ours = cagra.search(DeviceResources(seed=9), sp, loaded, q, K)
    else:
        ref = tmod.search(res, sp, index, q, K)
        ours = tmod.search(res, sp, loaded, q, K)
    assert torch.equal(ours[1], ref[1])
    assert torch.equal(ours[0], ref[0])
    assert _bytes(tmod, res, loaded) == _bytes(tmod, res, index)
