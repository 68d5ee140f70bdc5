"""The port's index verifier (``raft_tpu_torch.integrity.verify``) against
the JAX package's, on the CPU.

Indexes the JAX package built (IVF-Flat; IVF-PQ with 8-bit, 4-bit and
per-cluster books; CAGRA), each with recall canaries, are loaded by the
port through ``serialize``; ``verify`` passes on them at every level
(``full`` runs the port's canary health check), and on indexes the port
built.  Then one table of damages is applied identically to the JAX index
and to the port's copy — a duplicate id, an out-of-range size, an
out-of-range id, a NaN centroid, a stale norm cache, a stale recon row, a
stale ``list_recon_sq``, a stale int8 row and scale, a rotation that is
not orthonormal, a bad CAGRA edge, a self loop, a non-finite row — and
each raises ``IntegrityError`` with the same ``invariant`` and ``coord``
in both packages, counted alike in ``integrity.verify.failures``.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.observability as jobs
import raft_tpu_torch.observability as tobs
from raft_tpu import DeviceResources as JaxResources
from raft_tpu import integrity as jint
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import ivf_flat as jf
from raft_tpu.neighbors import ivf_pq as jp
from raft_tpu.random import make_blobs
from raft_tpu_torch import DeviceResources, integrity
from raft_tpu_torch.filters import TenantFilter
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

CPU = DeviceResources(device="cpu", seed=0)
JR = JaxResources(seed=7)
CANARIES = dict(canary_queries=12, canary_k=5, canary_floor=0.2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows():
    X, _ = make_blobs(900, 16, n_clusters=12, cluster_std=1.0, seed=21)
    return np.asarray(X)


def _carry(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.serialize(None, buf, index)
    buf.seek(0)
    return tmod.deserialize(CPU, buf)


PQ_KINDS = {"8-bit": dict(pq_bits=8), "4-bit": dict(pq_bits=4),
            "per-cluster": dict(pq_bits=8, codebook_kind=1)}


@pytest.fixture(scope="module")
def pairs(rows):
    """(JAX index, the port's copy) per kind; IVF-PQ with its int8 caches
    attached in both packages."""
    out = {"ivf_flat": jf.build(JR, jf.IndexParams(n_lists=8, **CANARIES),
                                rows),
           "cagra": jc.build(JR, jc.IndexParams(
               graph_degree=12, intermediate_graph_degree=24, **CANARIES),
               rows)}
    out = {k: (v, _carry({"ivf_flat": jf, "cagra": jc}[k],
                         {"ivf_flat": ivf_flat, "cagra": cagra}[k], v))
           for k, v in out.items()}
    # the norm cache in both: the port's first search attaches it (the JAX
    # package's attaches it only on a TPU), so the two copies stay alike
    # whichever test searches first
    j, t = out["ivf_flat"]
    t.list_data_sq = ivf_flat._row_norms(t.list_data)
    out["ivf_flat"] = (dataclasses.replace(j, list_data_sq=jnp.asarray(
        t.list_data_sq.numpy())), t)
    for name, kw in PQ_KINDS.items():
        j = jp.build(JR, jp.IndexParams(n_lists=8, pq_dim=8, **kw,
                                        **CANARIES), rows)
        j = jp._with_recon8(j)
        t = _carry(jp, ivf_pq, j)
        ivf_pq._with_recon8(t)
        out[f"ivf_pq-{name}"] = (j, t)
    return out


@pytest.mark.parametrize("level", ["structural", "statistical", "full"])
@pytest.mark.parametrize("kind", ["ivf_flat", "cagra", "ivf_pq-8-bit",
                                  "ivf_pq-4-bit", "ivf_pq-per-cluster"])
def test_loaded_indexes_pass_every_level(pairs, kind, level):
    j, t = pairs[kind]
    jint.verify(j, level, res=JR)
    integrity.verify(t, level, res=CPU)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "cagra"])
def test_port_built_indexes_pass(rows, kind):
    x = torch.tensor(rows)
    if kind == "ivf_flat":
        idx = ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=8,
                                                       **CANARIES), x)
        ivf_flat.search(CPU, ivf_flat.SearchParams(n_probes=2), idx, x[:5], 3)
    elif kind == "ivf_pq":
        idx = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=8, pq_dim=8,
                                                   **CANARIES), x)
        for mode in ("codes", "recon8"):
            ivf_pq.search(CPU, ivf_pq.SearchParams(n_probes=2,
                                                   scan_mode=mode),
                          idx, x[:5], 3)
    else:
        idx = cagra.build(CPU, cagra.IndexParams(
            graph_degree=12, intermediate_graph_degree=24, **CANARIES), x)
    integrity.verify(idx, "full", res=CPU)


def test_bad_level_and_missing_res_raise_alike(pairs):
    j, t = pairs["ivf_flat"]
    for ver, idx in ((jint.verify, j), (integrity.verify, t)):
        with pytest.raises(ValueError):
            ver(idx, "paranoid")
        with pytest.raises(ValueError):
            ver(idx, "full")
        with pytest.raises(TypeError):
            ver(object())


def test_full_without_canaries_names_the_same_invariant(rows):
    j = jf.build(JR, jf.IndexParams(n_lists=8), rows)
    t = _carry(jf, ivf_flat, j)
    with pytest.raises(jint.IntegrityError) as ref:
        jint.verify(j, "full", res=JR)
    with pytest.raises(integrity.IntegrityError) as ours:
        integrity.verify(t, "full", res=CPU)
    assert (ours.value.invariant, ours.value.coord) == \
        (ref.value.invariant, ref.value.coord)


# ---------------------------------------------------------------------------
# the damage table
# ---------------------------------------------------------------------------

def _fullest(sizes):
    li = int(np.argmax(sizes))
    return li, int(sizes[li])


def dup_id(a, idx):
    """Slot 0 of the fullest list takes the id in slot 0 of another."""
    sizes = np.asarray(idx["sizes"])
    li, _ = _fullest(sizes)
    other = next(i for i in range(len(sizes)) if i != li and sizes[i] > 0)
    a[li, 0] = a[other, 0]


def size_range(a, idx):
    a[1] = -3


def size_slots(a, idx):
    li, sz = _fullest(a)
    a[li] = sz - 1


def oob_id(a, idx):
    li, _ = _fullest(np.asarray(idx["sizes"]))
    a[li, 0] = int(np.asarray(idx["sizes"]).sum()) + 9


def nan_center(a, idx):
    a[2, 3] = np.nan


def stale_row0(delta):
    def fn(a, idx):
        li, _ = _fullest(np.asarray(idx["sizes"]))
        a[li, 0] += delta
    return fn


def not_orthonormal(a, idx):
    a *= 2.0


def stale_scale(a, idx):
    a[3] *= 1.5


def bad_edge(a, idx):
    a[0, 0] = a.shape[0] + 5


def self_loop(a, idx):
    a[3, 1] = 3


def inf_row(a, idx):
    a[5, 0] = np.inf


def stale_int8(a, idx):
    li, _ = _fullest(np.asarray(idx["sizes"]))
    a[li, 0, 1] = 127 if a[li, 0, 1] != 127 else -127


DAMAGES = {
    # name: (index kind, field, fn, level)
    "flat-dup-id": ("ivf_flat", "list_indices", dup_id, "structural"),
    "flat-size-range": ("ivf_flat", "list_sizes", size_range, "structural"),
    "flat-size-slots": ("ivf_flat", "list_sizes", size_slots, "structural"),
    "flat-oob-id": ("ivf_flat", "list_indices", oob_id, "structural"),
    "flat-nan-center": ("ivf_flat", "centers", nan_center, "statistical"),
    "flat-stale-norms": ("ivf_flat", "list_data_sq", stale_row0(7.0),
                         "structural"),
    "flat-inf-row": ("ivf_flat", "list_data", stale_row0(np.inf),
                     "statistical"),
    "pq-dup-id": ("ivf_pq-8-bit", "list_indices", dup_id, "structural"),
    "pq-size-range": ("ivf_pq-4-bit", "list_sizes", size_range,
                      "structural"),
    "pq-oob-id": ("ivf_pq-per-cluster", "list_indices", oob_id,
                  "structural"),
    "pq-nan-center": ("ivf_pq-8-bit", "centers", nan_center, "statistical"),
    "pq-stale-recon": ("ivf_pq-8-bit", "list_recon", stale_row0(1.0),
                       "structural"),
    "pq-stale-recon-4bit": ("ivf_pq-4-bit", "list_recon", stale_row0(1.0),
                            "structural"),
    "pq-stale-recon-per-cluster": ("ivf_pq-per-cluster", "list_recon",
                                   stale_row0(1.0), "structural"),
    "pq-stale-recon-sq": ("ivf_pq-8-bit", "list_recon_sq",
                          stale_row0(50.0), "structural"),
    "pq-stale-int8-row": ("ivf_pq-8-bit", "list_recon_i8", stale_int8,
                          "structural"),
    "pq-stale-int8-scale": ("ivf_pq-8-bit", "list_recon_scale", stale_scale,
                            "structural"),
    "pq-stale-int8-scale-per-cluster": ("ivf_pq-per-cluster",
                                        "list_recon_scale", stale_scale,
                                        "structural"),
    "pq-rotation": ("ivf_pq-4-bit", "rotation", not_orthonormal,
                    "statistical"),
    "cagra-bad-edge": ("cagra", "graph", bad_edge, "structural"),
    "cagra-self-loop": ("cagra", "graph", self_loop, "structural"),
    "cagra-inf-row": ("cagra", "dataset", inf_row, "statistical"),
}


# a damaged IVF-Flat row drops the norm cache (which the damage would
# leave stale), so the statistical check sees the row itself
DROPS = {"list_data": {"list_data_sq": None}}


def _damage_jax(index, field, fn):
    orig = getattr(index, field)
    dt = orig.dtype
    a = np.array(orig.astype(jnp.float32) if dt == jnp.bfloat16 else orig)
    fn(a, {"sizes": np.asarray(index.list_sizes)
           if hasattr(index, "list_sizes") else None})
    return dataclasses.replace(index, **{field: jnp.asarray(a, dtype=dt)},
                               **DROPS.get(field, {}))


def _damage_port(index, field, fn):
    orig = getattr(index, field)
    dt = orig.dtype
    a = (orig.float() if dt == torch.bfloat16 else orig).numpy().copy()
    fn(a, {"sizes": index.list_sizes.numpy()
           if hasattr(index, "list_sizes") else None})
    return dataclasses.replace(index, **{field: torch.tensor(a).to(dt)},
                               **DROPS.get(field, {}))


@pytest.mark.parametrize("damage", sorted(DAMAGES))
def test_each_damage_raises_the_same_invariant_and_coord(pairs, damage):
    kind, field, fn, level = DAMAGES[damage]
    j, t = pairs[kind]
    jbad, tbad = _damage_jax(j, field, fn), _damage_port(t, field, fn)
    for m in (jobs, tobs):
        m.reset()
    with jobs.collecting(), pytest.raises(jint.IntegrityError) as ref:
        jint.verify(jbad, level)
    with tobs.collecting(), pytest.raises(integrity.IntegrityError) as ours:
        integrity.verify(tbad, level)
    assert ours.value.invariant == ref.value.invariant
    assert ours.value.coord == ref.value.coord
    assert ours.value.invariant.split(".")[0] in (kind.split("-")[0],)
    counters = [{n: v for n, v in m.snapshot()["counters"].items()
                 if n.startswith("integrity")} for m in (jobs, tobs)]
    assert counters[0] == counters[1] and counters[1]
    for m in (jobs, tobs):
        m.reset()


def test_a_structural_damage_passes_below_its_level(pairs):
    """A NaN centroid is a statistical invariant: ``structural`` passes
    it in both packages."""
    j, t = pairs["ivf_flat"]
    jint.verify(_damage_jax(j, "centers", nan_center), "structural")
    integrity.verify(_damage_port(t, "centers", nan_center), "structural")


class Namespaces:
    """Tenant ranges as ``verify`` reads them, without the filter's own
    construction check (so an overlap reaches the verifier)."""

    def __init__(self, ranges):
        self.ranges = ranges

    def owner_of(self, i):
        return next((t for t, (lo, hi) in self.ranges.items()
                     if lo <= i < hi), None)


@pytest.mark.parametrize("tenant_filter", [False, True],
                         ids=["ranges", "TenantFilter"])
@pytest.mark.parametrize("case", ["disjoint", "overlap", "uncovered",
                                  "negative"])
@pytest.mark.parametrize("kind", ["ivf_flat", "cagra"])
def test_namespaces_raise_alike(pairs, kind, case, tenant_filter):
    from raft_tpu.filters import TenantFilter as JaxTenant

    j, t = pairs[kind]
    n = int(np.asarray(j.list_sizes).sum()) if kind == "ivf_flat" \
        else j.size
    ranges = {"disjoint": {"a": (0, n // 2), "b": (n // 2, n)},
              "overlap": {"a": (0, n // 2 + 5), "b": (n // 2, n)},
              "uncovered": {"a": (0, n // 2), "b": (n // 2 + 3, n)},
              "negative": {"a": (5, 2), "b": (n // 2, n)}}[case]
    outcome = []
    for ver, idx, tf in ((jint.verify, j, JaxTenant),
                         (integrity.verify, t, TenantFilter)):
        try:
            ns = (tf(ranges=ranges, n_rows=n) if tenant_filter
                  else Namespaces(ranges))
        except Exception as e:            # the filter itself refuses
            outcome.append(type(e).__name__)
            continue
        try:
            ver(idx, "structural", namespaces=ns)
            outcome.append(None)
        except Exception as e:
            outcome.append((type(e).__name__,
                            getattr(e, "invariant", None),
                            getattr(e, "coord", None)))
    assert outcome[0] == outcome[1]
    assert (outcome[1] is None) == (case == "disjoint")


def test_n_rows_widens_the_id_range_alike(pairs):
    j, t = pairs["ivf_flat"]
    jbad, tbad = _damage_jax(j, "list_indices", oob_id), \
        _damage_port(t, "list_indices", oob_id)
    n = int(np.asarray(j.list_sizes).sum()) + 100
    jint.verify(jbad, "structural", n_rows=n)
    integrity.verify(tbad, "structural", n_rows=n)
