"""The port's profile variants (PERF.md kernel table rows 10-13) against
the JAX profile scripts' Pallas kernels, on the CPU.

Each script under ``profiles/`` is loaded by file path and its
``pallas_call`` runs in Pallas interpret mode (a test-local monkeypatch
adds ``interpret=pltpu.InterpretParams()``); nothing under ``profiles/``
changes.  The port's plain versions run on the same numpy inputs:

- row 10, ``run_var``: a ``raft_tpu`` IVF-Flat index (4,000 × 32, 16
  lists, 4 probes, 64 queries) carried across; the JAX group slots map
  back to (query, probe) pairs through ``slot_pairs``.  Distances within
  1e-5 of ‖q‖² + max ‖x‖² (fp32 cancellation), ids equal at every rank
  strictly inside a pair's kt-th distance;
- row 11, ``pallas_gather``: bit-equal rows, f32 and bf16;
- rows 12-13, ``run`` and ``run_variant``: ``dmin`` within 1e-4
  relative, counts equal (the column sums of ``mxuonly`` within 1e-5
  relative), sums rtol 1e-3 / atol 1e-2 (the JAX script's own check).
  ``n`` is a multiple of the JAX tile, so no padded row enters a count.

Then each port profile runs end to end at tiny sizes on the CPU and prints
lines with the JAX scripts' fields.
"""

import functools
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raft_tpu import DeviceResources as JaxResources
from raft_tpu.neighbors import grouped
from raft_tpu.neighbors import ivf_flat as jax_flat
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.ops import kmeans_update as ku
from raft_tpu_torch.ops import pair_scan as ps
from raft_tpu_torch.ops import row_gather as rg
from raft_tpu_torch.profiles import gather_bench, group_kernel_decomp_r5
from raft_tpu_torch.profiles import kmeans_decomp_r5, kmeans_kernel_r5
from raft_tpu_torch.profiles import kmeans_tile_decomp

ROOT = pathlib.Path(__file__).resolve().parent.parent
_CONFIG_KEYS = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Loops of small torch ops slow ~100x when torch's intra-op pool
    oversubscribes the cores under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scripts():
    """The four JAX profile scripts, loaded by path; the ``sys.path``
    entry and the two jax config values their module bodies set are
    restored afterwards."""
    saved_path = list(sys.path)
    saved = {key: getattr(jax.config, key) for key in _CONFIG_KEYS}
    out = {}
    try:
        for name in ("group_kernel_decomp_r5", "gather_bench",
                     "kmeans_decomp_r5", "kmeans_kernel_r5"):
            spec = importlib.util.spec_from_file_location(
                f"jax_profile_{name}", ROOT / "profiles" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[name] = mod
    finally:
        sys.path[:] = saved_path
        for key, value in saved.items():
            jax.config.update(key, value)
    return out


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test in Pallas interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


# ---------------------------------------------------------------------------
# row 10: the grouped scan's variants
# ---------------------------------------------------------------------------

NQ, N_PROBES, KT = 64, 4, 10


@pytest.fixture(scope="module")
def flat():
    """A ``raft_tpu`` IVF-Flat index on 4,000 × 32 normal rows, its exact
    probes and pair groups for 64 queries, and the port's copy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    q = rng.normal(size=(NQ, 32)).astype(np.float32)
    index = jax_flat.build(JaxResources(seed=0), jax_flat.IndexParams(
        n_lists=16, kmeans_n_iters=5), x)
    probes = jax_flat._select_clusters(index.centers, jnp.asarray(q),
                                       N_PROBES, index.metric)
    ng = grouped.round_groups(int(grouped.num_groups(probes, 16)))
    gl, sp = grouped.build_groups(probes, 16, ng)
    port = ivf_flat.index_from_numpy(
        {n: np.asarray(getattr(index, n)) for n in (
            "centers", "list_data", "list_indices", "list_sizes")},
        metric=index.metric, device="cpu")
    return index, q, np.asarray(probes), gl, sp, port


def _jax_run_var(mod, flat, gather, extract):
    index, q, probes, gl, sp, _ = flat
    ld = index.list_data.astype(jnp.float32)
    dsq = jnp.sum(ld ** 2, axis=-1)
    qf = jnp.asarray(q)
    P = NQ * N_PROBES
    q_in = qf if gather else qf[jnp.where(sp < P, sp // N_PROBES, 0)]
    return mod.run_var(gl, sp, q_in, ld, dsq, index.list_indices, KT,
                       N_PROBES, gather, extract)


def _port_variant(flat, gather, extract):
    _, q, probes, _, _, port = flat
    qt = torch.from_numpy(q)
    q_in = qt if gather else group_kernel_decomp_r5.pregather(qt, N_PROBES)
    return ps.pair_scan_variant(
        q_in, torch.from_numpy(probes), port.list_data,
        ivf_flat._row_norms(port.list_data), port.list_indices, KT,
        gather=gather, extract=extract)


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("extract", [True, False])
def test_run_var_matches_the_jax_kernel(scripts, interpret, flat, gather,
                                        extract):
    index, q, _, _, sp, _ = flat
    ref = _jax_run_var(scripts["group_kernel_decomp_r5"], flat, gather,
                       extract)
    ours = _port_variant(flat, gather, extract)
    slots = np.asarray(sp)
    live = slots < NQ * N_PROBES
    qi, pj = slots[live] // N_PROBES, slots[live] % N_PROBES
    scale = float((q ** 2).sum(1).max()
                  + (np.asarray(index.list_data) ** 2).sum(-1).max())
    atol = 1e-5 * scale
    if not extract:
        rd = np.asarray(ref[0])[live]                  # (pairs, cap)
        pd = ours.numpy()[qi, pj]
        assert np.isfinite(pd).all()
        np.testing.assert_allclose(pd, rd, rtol=0, atol=atol)
        return
    rd, ri = np.asarray(ref[0])[live], np.asarray(ref[1])[live]
    pd, pi = ours[0].numpy()[qi, pj], ours[1].numpy()[qi, pj]
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(fin, np.isfinite(pd))
    np.testing.assert_array_equal(pi < 0, ~fin)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=0, atol=atol)
    for prow, pids, rrow, rids in zip(pd, pi, rd, ri):
        live_r = np.isfinite(rrow)
        if live_r.any():
            edge = rrow[live_r][-1]
            assert set(pids[prow < edge - atol]) == \
                set(rids[rrow < edge - atol])


# ---------------------------------------------------------------------------
# row 11: the row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pallas_gather_matches_the_plain_gather(scripts, interpret, dtype):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(1000, 128)).astype(np.float32)
    ids = rng.integers(0, 1000, size=256).astype(np.int32)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    if dtype == "bf16":
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    ref = scripts["gather_bench"].pallas_gather(jt, jnp.asarray(ids), 64)
    ours = rg.row_gather(tt, torch.from_numpy(ids), 64)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# rows 12-13: the k-means pass cut into its parts
# ---------------------------------------------------------------------------

N, DIM, K, TILE = 1024, 32, 100, 256


@pytest.fixture(scope="module")
def km():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(N, DIM)).astype(np.float32),
            rng.normal(size=(K, DIM)).astype(np.float32))


def _assert_cut_matches(cut, ours, sums, counts, dmin):
    p_sums, p_counts, p_dmin, _ = (None if t is None else t.numpy()
                                   for t in ours)
    np.testing.assert_allclose(p_dmin, dmin, rtol=1e-4,
                               atol=1e-4 * np.abs(dmin).max())
    if cut == "mxuonly":
        np.testing.assert_allclose(p_counts, counts, rtol=1e-5,
                                   atol=1e-5 * np.abs(counts).max())
    else:
        np.testing.assert_array_equal(p_counts, counts)
    np.testing.assert_allclose(p_sums, sums, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("which", ["mm", "mmmin", "mmargmin", "full"])
def test_kmeans_decomp_run_matches_the_jax_kernel(scripts, interpret, km,
                                                  which):
    x, c = km
    sums, counts, dmin = scripts["kmeans_decomp_r5"].run(
        jnp.asarray(x), jnp.asarray(c), TILE, which)
    ours = ku.kmeans_pass_cut_plain(torch.from_numpy(x), torch.from_numpy(c),
                                    which)
    _assert_cut_matches(which, ours, np.asarray(sums)[:K, :DIM],
                        np.asarray(counts)[0, :K], np.asarray(dmin)[:N, 0])


@pytest.mark.parametrize("which", ["uw", "mxuonly"])
def test_kmeans_run_variant_matches_the_jax_kernel(scripts, interpret, km,
                                                   which):
    x, c = km
    sums, counts, dmin = scripts["kmeans_kernel_r5"].run_variant(
        jnp.asarray(x), jnp.asarray(c), TILE, which)
    ours = ku.kmeans_pass_cut_plain(torch.from_numpy(x), torch.from_numpy(c),
                                    which)
    _assert_cut_matches(which, ours, np.asarray(sums), np.asarray(counts),
                        np.asarray(dmin))


def test_the_cuts_are_cumulative(km):
    """Each cut adds its part and keeps what the earlier cuts computed:
    mmmin's row min is mmargmin's and full's; full's labels are
    mmargmin's, summed in mmargmin's counts."""
    x, c = (torch.from_numpy(a) for a in km)
    out = {cut: ku.kmeans_pass_cut_plain(x, c, cut)
           for cut in ku.PASS_CUTS}
    for cut in ("mmargmin", "uw", "mxuonly"):
        assert torch.equal(out[cut][2], out["mmmin"][2])
    assert torch.equal(out["uw"][3], out["mmargmin"][3])
    assert float(out["mmargmin"][1][0]) == float(out["uw"][3].sum())
    assert torch.equal(out["uw"][1], torch.bincount(
        out["uw"][3].long(), minlength=K).float())
    assert bool((out["mm"][2] >= out["mmmin"][2]).all())


# ---------------------------------------------------------------------------
# the slice as a whole: each port profile end to end on the CPU
# ---------------------------------------------------------------------------

def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_group_kernel_decomp_profile_runs_on_the_cpu(capsys):
    lines = group_kernel_decomp_r5.decompose(2000, 32, 16, configs=(
        (16, 4), (8, 2)), reps=1, device="cpu")
    printed = _json_lines(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(lines))
    variants = [ln for ln in printed if "gather" in ln]
    assert len(variants) == 8
    for line in variants:
        assert set(line) == {"nlist", "n_pairs", "gather", "extract", "ms",
                             "us_per_pair"}
        assert line["ms"] is None and line["us_per_pair"] is None
    assert [ln["nlist"] for ln in printed if "query_gather_ms" in ln] == \
        [16, 8]


def test_gather_profile_runs_on_the_cpu(capsys):
    lines, match = gather_bench.profile(500, 64, 256, rows=(32, 64), reps=1,
                                        device="cpu")
    out = capsys.readouterr().out
    assert match and "match: True" in out
    assert _json_lines(out) == lines
    assert [(ln["impl"], ln["dtype"], ln["rows"]) for ln in lines] == [
        (impl, dt, r) for dt in ("f32", "bf16")
        for impl, r in (("index_select", None), ("row_gather", 32),
                        ("row_gather", 64))]


def test_kmeans_profiles_run_on_the_cpu(capsys):
    lines = kmeans_decomp_r5.profile(512, 32, 40, reps=1, device="cpu")
    assert [ln.get("variant") for ln in lines] == \
        list(kmeans_decomp_r5.CUTS) + [None]
    assert "yardstick" in lines[-1]
    lines, spot = kmeans_kernel_r5.profile(512, 32, 40, reps=1,
                                           device="cpu")
    assert [ln["variant"] for ln in lines] == ["base", "uw", "mxuonly"]
    assert all(ln["tile"] == kmeans_decomp_r5.TILE == "256x128"
               and ln["ms"] is None for ln in lines)
    assert spot == {"uw_sums_close": True, "uw_counts_equal": True,
                    "uw_dmin_close": True}
    assert len(_json_lines(capsys.readouterr().out)) == 5 + 4


def test_profile_mains_need_the_card(monkeypatch):
    """A profile measures device time only: without a card, main() stops
    before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (group_kernel_decomp_r5, gather_bench, kmeans_decomp_r5,
                kmeans_kernel_r5):
        with pytest.raises(SystemExit):
            mod.main()


@pytest.mark.parametrize("name", list(kmeans_tile_decomp.VARIANTS))
def test_kmeans_tile_decomp_variants_apply_to_the_tile_source(name):
    """Each variant of Kernel A's tile is one exact substitution in the
    committed source: the profile breaks loudly, not silently, if the tile
    changes under it."""
    base = (kmeans_tile_decomp._cuda.SRC_DIR
            / kmeans_tile_decomp.TILE_SOURCE).read_text()
    text = kmeans_tile_decomp.variant_source(name)
    assert (text == base) == (name == "as built")
    for old, new in kmeans_tile_decomp.VARIANTS[name]:
        assert old not in text and new in text


def test_kmeans_tile_decomp_needs_the_card(monkeypatch):
    """The variants are CUDA builds timed on the card: without one, main()
    stops before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(kmeans_tile_decomp, "build", lambda *a: pytest.fail(
        "built without a card"))
    with pytest.raises(SystemExit):
        kmeans_tile_decomp.main([])
