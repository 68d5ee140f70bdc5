"""The port's boundary validation, ``merge_window`` check and public names
against the JAX package, on the CPU (ROADMAP.md §3, faults 1-3).

The reviewer's inputs: 4,000 × 32 standard-normal rows (numpy seed 0) with
+inf at row 10, ``n_lists=16``, and 8 queries with NaN at row 3.  Every
entry point the JAX package validates runs in both packages under each
policy:

- ``raise``: the same exception class name, message, invariant and
  coordinate;
- ``mask``: the same flagged query rows ((+inf, -1)) and the other rows
  within the search-parity tolerances of the port's other tests, on
  indexes ``raft_tpu`` built and the port carries across; builds and fits
  keep the zeroed rows (the port's result equals its result on the rows
  zeroed by hand, draw for draw);
- ``off``: no validation work.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import DeviceResources as JaxResources
from raft_tpu import config as jax_config
from raft_tpu.cluster import kmeans as jax_kmeans
from raft_tpu.cluster import kmeans_balanced as jax_kb
from raft_tpu.cluster.kmeans_types import KMeansBalancedParams as JaxKBParams
from raft_tpu.cluster.kmeans_types import KMeansParams as JaxKMParams
from raft_tpu.integrity import boundary as jax_boundary
from raft_tpu.matrix.select_k import merge_topk as jax_merge_topk
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu.neighbors import cagra as jax_cagra
from raft_tpu.neighbors import ivf_flat as jax_flat
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors.refine import refine as jax_refine
from raft_tpu_torch import DeviceResources, config
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans_types import (KMeansBalancedParams,
                                                 KMeansParams)
from raft_tpu_torch.integrity import boundary
from raft_tpu_torch.integrity.errors import IntegrityError, ValidationError
from raft_tpu_torch.matrix import merge_topk
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      refine)

N, DIM, N_LISTS, BAD_ROW, BAD_QUERY, K = 4000, 32, 16, 10, 3, 10
CPU = DeviceResources(device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small torch ops slow ~100x when torch's intra-op pool
    oversubscribes the cores under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    bad, qbad = x.copy(), q.copy()
    bad[BAD_ROW, 5] = np.inf
    qbad[BAD_QUERY, 0] = np.nan
    zeroed, qzero = bad.copy(), qbad.copy()
    zeroed[BAD_ROW] = 0.0
    qzero[BAD_QUERY] = 0.0
    return dict(x=x, q=q, bad=bad, qbad=qbad, zeroed=zeroed, qzero=qzero)


@pytest.fixture(scope="module")
def built(data):
    """Clean ``raft_tpu`` indexes, each with the port's carried copy."""
    x = data["x"]
    pq = jax_pq.build(JaxResources(seed=0), jax_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=5), x)
    pq_port = ivf_pq.index_from_numpy(
        {n: np.asarray(getattr(pq, n)) for n in (
            "centers", "codebooks", "list_codes", "list_indices",
            "list_sizes", "rotation", "list_recon", "list_recon_sq")},
        metric=pq.metric, pq_bits=pq.pq_bits, device="cpu")
    flat = jax_flat.build(JaxResources(seed=0), jax_flat.IndexParams(
        n_lists=N_LISTS, kmeans_n_iters=5), x)
    flat_port = ivf_flat.index_from_numpy(
        {n: np.asarray(getattr(flat, n)) for n in (
            "centers", "list_data", "list_indices", "list_sizes")},
        metric=flat.metric, adaptive_centers=flat.adaptive_centers,
        device="cpu")
    cg = jax_cagra.build(JaxResources(seed=0), jax_cagra.IndexParams(
        intermediate_graph_degree=32, graph_degree=16), x)
    return dict(pq=(pq, pq_port), flat=(flat, flat_port), cagra=cg)


CAGRA_SP = dict(itopk_size=32, search_width=2, entry_points=256)


def _cagra_port(jax_index):
    """The port's copy of a searched ``raft_tpu`` CAGRA index with its walk
    cache (projection and entry set)."""
    (pdim, quant), = list(jax_index._walk_tables)
    _, proj, _ = jax_index._walk_tables[(pdim, quant)]
    _, _, eids = jax_index._walk_entries[(pdim, CAGRA_SP["entry_points"])]
    idx = cagra.index_from_numpy(np.asarray(jax_index.dataset),
                                 np.asarray(jax_index.graph),
                                 int(jax_index.metric), device="cpu")
    return cagra.attach_walk_cache(idx, np.asarray(proj), np.asarray(eids))


# ---------------------------------------------------------------------------
# the policy and the guard
# ---------------------------------------------------------------------------

def test_policy_default_setter_and_context_match_the_reference():
    assert config.SUPPORTED_VALIDATION_POLICIES == \
        jax_config.SUPPORTED_VALIDATION_POLICIES
    assert config.get_validation_policy() == "raise"
    with config.validation_policy("off"):
        assert config.get_validation_policy() == "off"
        with config.validation_policy("mask"):
            assert config.get_validation_policy() == "mask"
        assert config.get_validation_policy() == "off"
    assert config.get_validation_policy() == "raise"
    config.set_validation_policy("mask")
    try:
        assert config.get_validation_policy() == "mask"
    finally:
        config.set_validation_policy("raise")
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.set_validation_policy("strict")
        msgs.append(str(e.value))
        with pytest.raises(ValueError):
            mod.validation_policy("strict")
    assert msgs[0] == msgs[1]
    assert config.get_validation_policy() == "raise"


def test_validation_error_is_an_integrity_and_value_error():
    e = ValidationError("x", invariant="boundary.rank", coord=(2,))
    assert isinstance(e, IntegrityError) and isinstance(e, ValueError)
    assert (e.invariant, e.coord) == ("boundary.rank", (2,))
    assert IntegrityError("y").invariant == "unknown"


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("policy", ["raise", "mask", "off"])
def test_guard_matches_the_reference(data, policy, host):
    """guard_nonfinite on the device and its host twin: the same error
    under raise, the same zeroed rows and ok vector under mask, the input
    itself and no vector under off."""
    x = data["qbad"]
    port_in = x if host else torch.from_numpy(x)
    if policy == "raise":
        errs = []
        for fn, arg in ((boundary.guard_nonfinite, port_in),
                        (jax_boundary.guard_nonfinite,
                         x if host else jnp.asarray(x))):
            with pytest.raises(ValueError) as e:
                fn(arg, site="site", policy=policy, host=host)
            errs.append(e.value)
        assert str(errs[0]) == str(errs[1])
        assert (errs[0].invariant, errs[0].coord) == \
            (errs[1].invariant, errs[1].coord) == ("boundary.nonfinite",
                                                   (BAD_QUERY,))
        return
    out, ok = boundary.guard_nonfinite(port_in, site="site", policy=policy,
                                       host=host)
    ref, ref_ok = jax_boundary.guard_nonfinite(
        x if host else jnp.asarray(x), site="site", policy=policy, host=host)
    if policy == "off":
        assert out is port_in and ok is None and ref_ok is None
        return
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref_ok))
    assert not bool(np.asarray(ok)[BAD_QUERY])


def test_guard_passes_integers_and_mask_outputs_flag_rows():
    ids = torch.arange(6).reshape(3, 2)
    assert boundary.guard_nonfinite(ids, site="s", policy="mask") == \
        (ids, None)
    d = torch.zeros(3, 2)
    i = torch.zeros(3, 2, dtype=torch.int32)
    ok = torch.tensor([True, False, True])
    for select_min, worst in ((True, float("inf")), (False, -float("inf"))):
        md, mi = boundary.mask_search_outputs(d, i, ok,
                                              select_min=select_min)
        rd, ri = jax_boundary.mask_search_outputs(
            jnp.asarray(d.numpy()), jnp.asarray(i.numpy()),
            jnp.asarray(ok.numpy()), select_min=select_min)
        np.testing.assert_array_equal(md.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ri))
        assert float(md[1, 0]) == worst and int(mi[1, 1]) == -1
    assert boundary.mask_search_outputs(d, i, None) == (d, i)


@pytest.mark.parametrize("shape,kw", [((4, 3, 2), {}), ((4, 3), {"dim": 5}),
                                      ((0, 3), {"allow_empty": False})])
def test_check_matrix_shape_checks_match_the_reference(shape, kw):
    x = np.zeros(shape, np.float32)
    errs = []
    for fn, arg in ((boundary.check_matrix, torch.from_numpy(x)),
                    (jax_boundary.check_matrix, jnp.asarray(x))):
        with pytest.raises(ValueError) as e:
            fn(arg, "X", site="site", **kw)
        errs.append(e.value)
    assert str(errs[0]) == str(errs[1])
    assert errs[0].invariant == errs[1].invariant
    assert boundary.check_matrix(torch.from_numpy(x), "X", site="site",
                                 policy="off", **kw)[1] is None


# ---------------------------------------------------------------------------
# every validated entry point, under "raise": the same error in both
# ---------------------------------------------------------------------------

def _jr():
    return JaxResources(seed=0)


RAISE_CASES = {
    "ivf_pq.build": (
        lambda d, b: jax_pq.build(_jr(), jax_pq.IndexParams(
            n_lists=N_LISTS), d["bad"]),
        lambda d, b: ivf_pq.build(CPU, ivf_pq.IndexParams(
            n_lists=N_LISTS), d["bad"])),
    "ivf_pq.extend": (
        lambda d, b: jax_pq.extend(_jr(), b["pq"][0], d["bad"][:100]),
        lambda d, b: ivf_pq.extend(CPU, b["pq"][1], d["bad"][:100])),
    "ivf_pq.search": (
        lambda d, b: jax_pq.search(_jr(), jax_pq.SearchParams(), b["pq"][0],
                                   d["qbad"], K),
        lambda d, b: ivf_pq.search(CPU, ivf_pq.SearchParams(), b["pq"][1],
                                   d["qbad"], K)),
    "ivf_flat.build": (
        lambda d, b: jax_flat.build(_jr(), jax_flat.IndexParams(
            n_lists=N_LISTS), d["bad"]),
        lambda d, b: ivf_flat.build(CPU, ivf_flat.IndexParams(
            n_lists=N_LISTS), d["bad"])),
    "ivf_flat.extend": (
        lambda d, b: jax_flat.extend(_jr(), b["flat"][0], d["bad"][:100]),
        lambda d, b: ivf_flat.extend(CPU, b["flat"][1], d["bad"][:100])),
    "ivf_flat.search": (
        lambda d, b: jax_flat.search(_jr(), jax_flat.SearchParams(),
                                     b["flat"][0], d["qbad"], K),
        lambda d, b: ivf_flat.search(CPU, ivf_flat.SearchParams(),
                                     b["flat"][1], d["qbad"], K)),
    "cagra.build": (
        lambda d, b: jax_cagra.build(_jr(), jax_cagra.IndexParams(),
                                     d["bad"]),
        lambda d, b: cagra.build(CPU, cagra.IndexParams(), d["bad"])),
    "cagra.search": (
        lambda d, b: jax_cagra.search(_jr(), jax_cagra.SearchParams(),
                                      b["cagra"], d["qbad"], K),
        lambda d, b: cagra.search(CPU, cagra.SearchParams(), cagra.
                                  index_from_numpy(np.asarray(
                                      b["cagra"].dataset), np.asarray(
                                      b["cagra"].graph), device="cpu"),
                                  d["qbad"], K)),
    "brute_force.knn": (
        lambda d, b: jax_bf.knn(_jr(), d["x"], d["qbad"], K),
        lambda d, b: brute_force.knn(CPU, d["x"], d["qbad"], K)),
    "refine": (
        lambda d, b: jax_refine(_jr(), d["x"], d["qbad"],
                                       np.zeros((8, 20), np.int32), K),
        lambda d, b: refine(CPU, d["x"], d["qbad"],
                            np.zeros((8, 20), np.int32), K)),
    "kmeans.fit": (
        lambda d, b: jax_kmeans.fit(_jr(), JaxKMParams(n_clusters=8),
                                    d["bad"]),
        lambda d, b: kmeans.fit(CPU, KMeansParams(n_clusters=8), d["bad"])),
    "kmeans.predict": (
        lambda d, b: jax_kmeans.predict(_jr(), JaxKMParams(n_clusters=8),
                                        d["bad"], d["x"][:8]),
        lambda d, b: kmeans.predict(CPU, KMeansParams(n_clusters=8),
                                    d["bad"], d["x"][:8])),
    "kmeans.fit_predict": (
        lambda d, b: jax_kmeans.fit_predict(_jr(), JaxKMParams(n_clusters=8),
                                            d["bad"]),
        lambda d, b: kmeans.fit_predict(CPU, KMeansParams(n_clusters=8),
                                        d["bad"])),
    "kmeans.transform": (
        lambda d, b: jax_kmeans.transform(_jr(), JaxKMParams(n_clusters=8),
                                          d["bad"], d["x"][:8]),
        lambda d, b: kmeans.transform(CPU, KMeansParams(n_clusters=8),
                                      d["bad"], d["x"][:8])),
    "kmeans_balanced.fit": (
        lambda d, b: jax_kb.fit(_jr(), JaxKBParams(), d["bad"], 8),
        lambda d, b: kmeans_balanced.fit(CPU, KMeansBalancedParams(),
                                         d["bad"], 8)),
    "kmeans_balanced.predict": (
        lambda d, b: jax_kb.predict(_jr(), JaxKBParams(), d["bad"],
                                    d["x"][:8]),
        lambda d, b: kmeans_balanced.predict(CPU, KMeansBalancedParams(),
                                             d["bad"], d["x"][:8])),
    "kmeans_balanced.fit_predict": (
        lambda d, b: jax_kb.fit_predict(_jr(), JaxKBParams(), d["bad"], 8),
        lambda d, b: kmeans_balanced.fit_predict(
            CPU, KMeansBalancedParams(), d["bad"], 8)),
}


@pytest.mark.parametrize("entry", sorted(RAISE_CASES))
def test_raise_policy_raises_what_the_reference_raises(data, built, entry):
    """A non-finite input row raises ValidationError with the JAX
    package's message letter for letter, its invariant and its row."""
    errs = []
    for call in RAISE_CASES[entry]:
        with pytest.raises(ValueError) as e:
            call(data, built)
        errs.append(e.value)
    ref, port = errs
    assert isinstance(port, ValidationError)
    assert type(port).__name__ == type(ref).__name__ == "ValidationError"
    assert str(port) == str(ref)
    assert (port.invariant, port.coord) == (ref.invariant, ref.coord)
    row = BAD_QUERY if entry.endswith(("search", "knn", "refine")) \
        else BAD_ROW
    assert port.coord == (row,)


# ---------------------------------------------------------------------------
# "mask": flagged query rows, the rest as the reference returns them
# ---------------------------------------------------------------------------

def _assert_flagged_and_close(port, ref, atol, overlap=1.0):
    pd, pi = (np.asarray(t) for t in port)
    rd, ri = (np.asarray(t) for t in ref)
    for d, i in ((pd, pi), (rd, ri)):
        assert np.isposinf(d[BAD_QUERY]).all() and (i[BAD_QUERY] == -1).all()
    good = np.arange(len(pd)) != BAD_QUERY
    np.testing.assert_allclose(pd[good], rd[good], rtol=1e-4, atol=atol)
    same = np.mean([len(set(a) & set(b)) / len(a)
                    for a, b in zip(pi[good], ri[good])])
    assert same >= overlap, same


def _masked(fn):
    with config.validation_policy("mask"), \
            jax_config.validation_policy("mask"):
        return fn()


def test_mask_ivf_pq_search(data, built):
    """IVF-PQ on the carried index: ids overlap >= 0.99, distances 1e-4
    (tests/test_torch_ivf_pq.py's public-search tolerances)."""
    jidx, port = built["pq"]
    sp = dict(n_probes=4, exact_coarse=True)
    ref = _masked(lambda: jax_pq.search(_jr(), jax_pq.SearchParams(**sp),
                                        jidx, jnp.asarray(data["qbad"]), K))
    ours = _masked(lambda: ivf_pq.search(CPU, ivf_pq.SearchParams(**sp),
                                         port, data["qbad"], K))
    _assert_flagged_and_close(ours, ref, 1e-4, overlap=0.99)


def test_mask_ivf_flat_search(data, built):
    """IVF-Flat on the carried index: fp32 distances within 1e-5 of the
    scale ‖q‖² + max ‖x‖², the same ids."""
    jidx, port = built["flat"]
    sp = dict(n_probes=4)
    ref = _masked(lambda: jax_flat.search(_jr(), jax_flat.SearchParams(**sp),
                                          jidx, jnp.asarray(data["qbad"]),
                                          K))
    ours = _masked(lambda: ivf_flat.search(CPU, ivf_flat.SearchParams(**sp),
                                           port, data["qbad"], K))
    scale = float((data["q"] ** 2).sum(1).max() + (data["x"] ** 2).sum(1)
                  .max())
    _assert_flagged_and_close(ours, ref, 1e-5 * scale)


def test_mask_cagra_search(data, built):
    """CAGRA on the carried index and walk cache: ids >= 0.99 of slots,
    distances 1e-5 (tests/test_torch_cagra.py's walk parity)."""
    jidx = built["cagra"]
    sp = jax_cagra.SearchParams(**CAGRA_SP)
    ref = _masked(lambda: jax_cagra.search(JaxResources(seed=3), sp, jidx,
                                           jnp.asarray(data["qbad"]), K))
    ours = _masked(lambda: cagra.search(
        CPU, cagra.SearchParams(**dataclasses.asdict(sp)), _cagra_port(jidx),
        data["qbad"], K))
    _assert_flagged_and_close(ours, ref, 1e-5, overlap=0.99)


def test_mask_brute_force_and_refine(data):
    """Exact kNN and the exact re-rank of its top 20: distances 1e-4, the
    same ids."""
    x, qbad = data["x"], data["qbad"]
    ref = _masked(lambda: jax_bf.knn(_jr(), x, qbad, K))
    ours = _masked(lambda: brute_force.knn(CPU, x, qbad, K))
    _assert_flagged_and_close(ours, ref, 1e-3)
    cand = np.asarray(brute_force.knn(CPU, x, data["qzero"], 20)[1])
    ref = _masked(lambda: jax_refine(_jr(), x, qbad, cand, K))
    ours = _masked(lambda: refine(CPU, x, qbad, cand, K))
    _assert_flagged_and_close(ours, ref, 1e-3)


def test_mask_predicts_label_the_zeroed_row(data):
    """predict / transform keep every row (the zeroed one included) and
    agree with the reference on the same centroids."""
    bad, c = data["bad"], data["x"][:8]
    ref = _masked(lambda: jax_kmeans.predict(_jr(), JaxKMParams(
        n_clusters=8), bad, c))
    ours = _masked(lambda: kmeans.predict(CPU, KMeansParams(n_clusters=8),
                                          bad, c))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(float(ours[1]), float(ref[1]), rtol=1e-5)
    ref = _masked(lambda: jax_kb.predict(_jr(), JaxKBParams(), bad, c))
    ours = _masked(lambda: kmeans_balanced.predict(
        CPU, KMeansBalancedParams(), bad, c))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ref = _masked(lambda: jax_kmeans.transform(_jr(), JaxKMParams(
        n_clusters=8), bad, c))
    ours = _masked(lambda: kmeans.transform(CPU, KMeansParams(n_clusters=8),
                                            bad, c))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert np.isfinite(ours.numpy()).all()


BUILD_CASES = {
    "ivf_pq.build": lambda x: ivf_pq.build(
        DeviceResources(seed=1, device="cpu"), ivf_pq.IndexParams(
            n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3), x).centers,
    "ivf_pq.extend": lambda x: ivf_pq.extend(
        CPU, ivf_pq.build(DeviceResources(seed=1, device="cpu"),
                          ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=8,
                                             kmeans_n_iters=3,
                                             add_data_on_build=False),
                          np.zeros((N_LISTS, DIM), np.float32) + np.arange(
                              N_LISTS, dtype=np.float32)[:, None]),
        x).list_codes,
    "ivf_flat.build": lambda x: ivf_flat.build(
        DeviceResources(seed=1, device="cpu"), ivf_flat.IndexParams(
            n_lists=N_LISTS, kmeans_n_iters=3), x).list_data,
    "cagra.build": lambda x: cagra.build(
        CPU, cagra.IndexParams(intermediate_graph_degree=16,
                               graph_degree=8), x[:1000]).graph,
    "kmeans.fit": lambda x: kmeans.fit(
        CPU, KMeansParams(n_clusters=8, max_iter=5), x)[0],
    "kmeans_balanced.fit": lambda x: kmeans_balanced.fit(
        DeviceResources(seed=1, device="cpu"), KMeansBalancedParams(
            n_iters=3), x, 8),
}


@pytest.mark.parametrize("entry", sorted(BUILD_CASES))
def test_mask_builds_keep_the_zeroed_rows(data, entry):
    """Under mask a build or fit takes the bad row as zeros — the JAX
    build discards ``ok_rows`` — so its result equals, draw for draw, the
    result on the rows zeroed by hand."""
    build = BUILD_CASES[entry]
    with config.validation_policy("mask"):
        masked = build(data["bad"])
    with config.validation_policy("off"):
        ref = build(data["zeroed"])
    assert torch.isfinite(masked.float()).all()
    assert torch.equal(masked, ref)


# ---------------------------------------------------------------------------
# "off": no validation work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["ivf_pq.search", "ivf_flat.search",
                                   "brute_force.knn", "refine",
                                   "kmeans.predict",
                                   "kmeans_balanced.predict"])
def test_off_policy_does_no_validation(data, built, entry):
    """Under off, a NaN query or an inf row goes through unchecked: no
    error, and the non-finite row's own outputs carry no flag."""
    with config.validation_policy("off"):
        out = RAISE_CASES[entry][1](data, built)
    first = out[0] if isinstance(out, tuple) else out
    assert first.shape[0] in (8, N)


def test_off_policy_builds_on_a_non_finite_row(data):
    """ROADMAP.md §3's observation, now only under off: the IVF-Flat build
    takes the +inf row as it is."""
    with config.validation_policy("off"):
        idx = ivf_flat.build(DeviceResources(seed=0, device="cpu"),
                             ivf_flat.IndexParams(n_lists=N_LISTS,
                                                  kmeans_n_iters=3),
                             data["bad"])
    assert idx.size == N
    assert not bool(torch.isfinite(idx.list_data).all())


# ---------------------------------------------------------------------------
# fault 3: merge_window; fault 2: the reference's public names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [-1, "wide"])
def test_invalid_merge_window_raises_in_both(data, built, value):
    jidx, port = built["pq"]
    with pytest.raises(ValueError) as ref:
        jax_pq.search(_jr(), jax_pq.SearchParams(merge_window=value), jidx,
                      data["q"], K)
    with pytest.raises(ValueError) as ours:
        ivf_pq.search(CPU, ivf_pq.SearchParams(merge_window=value), port,
                      data["q"], K)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("value", ["auto", None, 0, 2])
def test_valid_merge_window_selects_nothing(data, built, value):
    _, port = built["pq"]
    base = ivf_pq.search(CPU, ivf_pq.SearchParams(), port, data["q"], K)
    out = ivf_pq.search(CPU, ivf_pq.SearchParams(merge_window=value), port,
                        data["q"], K)
    assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])


@pytest.mark.parametrize("call,item", [
    (lambda idx: ivf_pq.delete(CPU, idx, [1]), None),
    (lambda idx: ivf_pq.upsert(CPU, idx, [1], np.zeros((1, DIM))), None),
    (lambda idx: ivf_pq.compact(CPU, idx), None),
    (lambda idx: ivf_pq.calibrate_group_capacity(CPU, idx,
                                                 np.zeros((2, DIM)), 4),
     "LUT scan"),
    (lambda idx: brute_force.knn_merge_parts(torch.zeros(2, 1, 3),
                                             torch.zeros(2, 1, 3),
                                             n_samples=5), "primitives"),
    (lambda idx: kmeans_balanced.build_clusters(
        CPU, KMeansBalancedParams(), np.zeros((8, DIM)), 2), "primitives"),
], ids=["delete", "upsert", "compact", "calibrate_group_capacity",
        "knn_merge_parts", "build_clusters"])
def test_reference_names_not_ported_raise_naming_their_item(built, call,
                                                            item, request):
    """Each public name of the reference that was once deferred runs now:
    the mutation names return the next generation; the names of the LUT
    scan's and the primitives' items (shipped since) return what the JAX
    package's return on the same inputs."""
    index = built["pq"][1]
    if item is None:
        assert call(index).generation == index.generation + 1
        return
    jres = JaxResources(seed=0)
    ref_index = built["pq"][0]
    name = request.node.callspec.id
    ref = {
        "calibrate_group_capacity": lambda: jax_pq.calibrate_group_capacity(
            jres, ref_index, np.zeros((2, DIM)), 4),
        "knn_merge_parts": lambda: jax_bf.knn_merge_parts(
            jnp.zeros((2, 1, 3)), jnp.zeros((2, 1, 3)), n_samples=5),
        "build_clusters": lambda: jax_kb.build_clusters(
            jres, JaxKBParams(), np.zeros((8, DIM)), 2)}[name]
    def outcome(fn):
        try:
            return fn(), None
        except ValueError as err:      # the merge refuses float ids
            return None, type(err)

    saved = (index.group_est, ref_index.group_est)
    (ours, ours_err), (theirs, theirs_err) = outcome(
        lambda: call(index)), outcome(ref)
    index.group_est, ref_index.group_est = saved
    assert ours_err == theirs_err
    if name == "calibrate_group_capacity":
        assert ours == theirs
    elif ours is not None:
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tiled_brute_force_knn_matches_the_reference(data):
    ref = jax_bf.tiled_brute_force_knn(_jr(), data["x"], data["q"], K)
    ours = brute_force.tiled_brute_force_knn(CPU, data["x"], data["q"], K)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("select_min", [True, False])
def test_merge_topk_matches_the_reference_with_ties_and_infinities(
        select_min):
    """Ties keep the running entry (the lower position of [best | new]),
    ±inf merge like any value — as lax.top_k orders them."""
    rng = np.random.default_rng(4)
    best = np.sort(rng.integers(0, 6, (16, 8)).astype(np.float32), 1)
    new = rng.integers(0, 6, (16, 5)).astype(np.float32)
    best[:4, -3:] = np.inf
    new[2:6, :2] = -np.inf if select_min else np.inf
    new[6, :] = np.inf
    if not select_min:
        best = best[:, ::-1].copy()
    bi = rng.integers(0, 100, best.shape).astype(np.int32)
    ni = 100 + rng.integers(0, 100, new.shape).astype(np.int32)
    ref = jax_merge_topk(jnp.asarray(best), jnp.asarray(bi),
                                  jnp.asarray(new), jnp.asarray(ni),
                                  select_min=select_min)
    ours = merge_topk(*(torch.from_numpy(a) for a in (best, bi, new, ni)),
                      select_min=select_min)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


def test_kmeans_balanced_fit_predict_is_fit_then_predict(data):
    """``(centroids, labels)`` in the reference's order: the port's own
    fit then predict, draw for draw; the labels as the reference assigns
    them to those centroids."""
    params = KMeansBalancedParams(n_iters=3)
    c, labels = kmeans_balanced.fit_predict(
        DeviceResources(seed=2, device="cpu"), params, data["x"], 8)
    c_ref = kmeans_balanced.fit(DeviceResources(seed=2, device="cpu"),
                                params, data["x"], 8)
    assert torch.equal(c, c_ref)
    assert torch.equal(labels, kmeans_balanced.predict(CPU, params,
                                                       data["x"], c))
    ref = jax_kb.predict(_jr(), JaxKBParams(n_iters=3), data["x"],
                         c.numpy())
    assert np.mean(labels.numpy() == np.asarray(ref)) >= 0.999
