"""The port's durable ingest (``raft_tpu_torch.serving.ingest``) against the
JAX package's, on the CPU.

- The WAL is byte for byte the JAX package's: ``encode_record`` gives the
  JAX bytes for upserts and deletes; a log the JAX ``IngestServer`` wrote
  replays in the port to the same memtable (``digest()``, the JAX
  package's bytes in its order), and a log the port wrote replays in the
  JAX package; ``scan_wal`` reads the same records and stops at the same
  torn byte, and raises at the same mid-log corruption
  (``raft_tpu/serving/ingest.py:33-47``).
- The kill matrix: a fault injected at each of the five sites
  (``ingest.append`` / ``apply`` / ``fsync`` / ``fold`` / ``truncate``)
  loses no acknowledged write after ``recover`` (rolled forward past a
  committed fold, else two independent replays agree bit for bit).
- Serving: writes through ``Server.write`` are visible to the next search
  before any fold, deletes mask main-index hits, a fold swaps a new
  generation in through ``Server.swap_index`` and the WAL empties.

A card test (marked ``cuda``) writes after warm-up and finds the upsert
through the replayed graphs (the delta merge runs after the replay), a
deleted id never returned; it needs neither jax nor raft_tpu::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_ingest.py
"""

import numpy as np
import pytest
import torch

try:
    from raft_tpu import DeviceResources as JaxResources
    from raft_tpu.serving import ingest as jing
except ImportError:   # a machine with the port only: the card test runs
    JaxResources = jing = None
from raft_tpu_torch import DeviceResources, serving
from raft_tpu_torch.core import aot
from raft_tpu_torch.core.serialize import CorruptIndexError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, mutate
from raft_tpu_torch.resilience.faults import FaultInjected, FaultPlan
from raft_tpu_torch.serving import ingest as ting

CPU = DeviceResources(device="cpu", seed=42)
DIM = 16
TIMEOUT = 30
KILL_SITES = ("ingest.append", "ingest.apply", "ingest.fsync",
              "ingest.fold", "ingest.truncate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_jax():
    if jing is None:
        pytest.skip("needs jax and raft_tpu (the reference package)")


def _rows(rng, n):
    return rng.normal(size=(n, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(2000, DIM)).astype(np.float32),
            rng.normal(size=(8, DIM)).astype(np.float32))


@pytest.fixture(scope="module")
def flat_index(dataset):
    return ivf_flat.build(CPU, ivf_flat.IndexParams(n_lists=16,
                                                    kmeans_n_iters=4),
                          dataset[0])


def _ingest(mod, tmp_path, res, **cfg):
    cfg.setdefault("wal_dir", str(tmp_path / "wal"))
    cfg.setdefault("memtable_capacity", 32)
    cfg.setdefault("tomb_capacity", 32)
    return mod.IngestServer(res, mod.IngestConfig(**cfg), dim=DIM)


def _script(srv, seed=0):
    """Upserts, overwrites and deletes (ids 0-39), one record each."""
    rng = np.random.default_rng(seed)
    for j in range(0, 40, 4):
        srv.write(np.arange(j, j + 4), _rows(rng, 4))
    srv.write(np.array([3, 7, 100]), op="delete")
    srv.write(np.array([7, 41]), _rows(rng, 2))
    srv.write(np.array([0, 1, 2]), op="delete")


# ---------------------------------------------------------------------------
# the WAL, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,n", [(1, 1), (1, 5), (2, 1), (2, 7)])
def test_encode_record_gives_the_jax_bytes(op, n):
    _need_jax()
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 1 << 40, n)
    vecs = _rows(rng, n) if op == 1 else None
    assert ting.encode_record(17 + n, op, ids, vecs) == \
        jing.encode_record(17 + n, op, ids, vecs)


def _log(n=4):
    rng = np.random.default_rng(1)
    recs = [ting.encode_record(j + 1, 1, np.arange(j, j + 3), _rows(rng, 3))
            for j in range(n)]
    return recs, b"".join(recs)


@pytest.mark.parametrize("cut", ["none", "header", "body", "crc_last",
                                 "garbage"])
def test_scan_wal_reads_as_the_jax_scan(cut):
    """The same records and the same first torn byte."""
    _need_jax()
    recs, data = _log()
    if cut == "header":
        data = data + recs[0][:10]
    elif cut == "body":
        data = data[:-5]
    elif cut == "crc_last":
        b = bytearray(data)
        b[-1] ^= 0xFF
        data = bytes(b)
    elif cut == "garbage":
        data = data + b"\x00" * 64
    tr, tend = ting.scan_wal(data)
    jr, jend = jing.scan_wal(data)
    assert tend == jend and len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert (a.lsn, a.op) == (b.lsn, b.op)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.vectors, b.vectors)


@pytest.mark.parametrize("where", ["crc", "frame"])
def test_mid_log_corruption_raises_at_the_jax_offset(where):
    _need_jax()
    recs, data = _log()
    b = bytearray(data)
    off = len(recs[0])
    if where == "crc":
        b[off + 30] ^= 0xFF
    else:
        b[off:off + 4] = b"XXXX"
    with pytest.raises(CorruptIndexError) as terr:
        ting.scan_wal(bytes(b))
    with pytest.raises(Exception) as jerr:
        jing.scan_wal(bytes(b))
    assert str(terr.value) == str(jerr.value)
    assert f"offset {off}" in str(terr.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_wal_replays_to_the_same_memtable_in_either_package(tmp_path,
                                                              writer):
    _need_jax()
    mods = {"jax": (jing, JaxResources(seed=0)), "port": (ting, CPU)}
    reader = "port" if writer == "jax" else "jax"
    w = _ingest(mods[writer][0], tmp_path, mods[writer][1])
    w.recover()
    _script(w)
    want = w.memtable.digest()
    w.close()
    r = _ingest(mods[reader][0], tmp_path, mods[reader][1])
    r.recover()
    assert r.memtable.digest() == want
    assert r.stats()["last_lsn"] == 13
    r.close()


def test_torn_tail_is_repaired_and_replay_continues(tmp_path):
    w = _ingest(ting, tmp_path, CPU)
    w.recover()
    _script(w)
    w.close()
    path = tmp_path / "wal" / "wal.log"
    whole = path.read_bytes()
    path.write_bytes(whole[:-7])
    r = _ingest(ting, tmp_path, CPU)
    r.recover()
    assert r.stats()["last_lsn"] == 12
    assert len(path.read_bytes()) < len(whole) - 7
    r.close()


# ---------------------------------------------------------------------------
# the kill matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_then_recover_loses_no_acked_write(tmp_path, flat_index, site):
    rng = np.random.default_rng(7)
    srv = _ingest(ting, tmp_path, CPU)
    srv.recover(base_index=flat_index)
    acked = {}
    for j in range(4):
        row = _rows(rng, 1)
        srv.write(np.array([j]), row)
        acked[j] = row[0]
    with FaultPlan(seed=1).at(site, times=1).active():
        with pytest.raises(FaultInjected):
            if site in ("ingest.fold", "ingest.truncate"):
                srv.fold()
            else:
                srv.write(np.array([99]), _rows(rng, 1))
    srv.close()
    r1 = _ingest(ting, tmp_path, CPU)
    idx1 = r1.recover(base_index=flat_index)
    if mutate.generation(idx1) > mutate.generation(flat_index):
        # the commit marker landed: the fold rolled forward
        sp = ivf_flat.SearchParams(n_probes=16)
        for i, row in acked.items():
            _, got = ivf_flat.search(CPU, sp, idx1, row[None, :], 1)
            assert int(got[0, 0]) == i, site
        assert r1.memtable.live_rows == 0
        r1.close()
        return
    d1 = r1.memtable.digest()
    r1.close()
    r2 = _ingest(ting, tmp_path, CPU)
    r2.recover(base_index=flat_index)
    assert r2.memtable.digest() == d1
    for i, row in acked.items():
        d, got = r2.memtable.search(row[None, :], 1)
        assert int(got[0, 0]) == i and float(d[0, 0]) == pytest.approx(
            0.0, abs=1e-5), site
    r2.close()


def test_backpressure_and_quota_shed_before_the_wal(tmp_path):
    srv = _ingest(ting, tmp_path, CPU, max_memtable_rows=4,
                  write_quotas={"metered": (1.0, 2.0)})
    srv.recover()
    rng = np.random.default_rng(0)
    srv.write(np.arange(4), _rows(rng, 4))
    with pytest.raises(serving.Overloaded):
        srv.write(np.array([9]), _rows(rng, 1))
    with pytest.raises(serving.QuotaExceeded):
        srv.write(np.arange(3), op="delete", tenant="metered")
    srv.write(np.array([0]), op="delete")
    assert srv.stats()["last_lsn"] == 2
    srv.close()


# ---------------------------------------------------------------------------
# serving: writes visible, deletes masked, a fold swapped in
# ---------------------------------------------------------------------------

def test_writes_serve_before_and_after_a_fold(tmp_path, dataset):
    db, q = dataset
    index = ivf_pq.build(CPU, ivf_pq.IndexParams(n_lists=16, pq_dim=8,
                                                 kmeans_n_iters=4), db)
    sp = ivf_pq.SearchParams(n_probes=16)
    ex = serving.Executor(CPU, "ivf_pq", index, ks=(5,), max_batch=8,
                          search_params=sp)
    ing = _ingest(ting, tmp_path, CPU)
    srv = serving.Server(ex, serving.ServerConfig(max_batch=8,
                                                  max_wait_us=1_000))
    srv.attach_ingest(ing)
    base = ing.recover(base_index=index)
    assert base is index
    far = np.full((2, DIM), 40.0, np.float32)
    far[1] *= -1
    _, near = ivf_pq.search(CPU, sp, index, q[:1], 5)
    victim = int(near[0, 0])
    with ing, srv:
        misses = aot.executables().misses
        srv.write(np.array([5000, 5001]), far)
        srv.write(np.array([victim]), op="delete")
        _, i = srv.search(far, 5, timeout=TIMEOUT)
        assert i[:, 0].tolist() == [5000, 5001]
        _, i = srv.search(q[:1], 5, timeout=TIMEOUT)
        assert victim not in i
        folded = ing.fold()
        assert folded is not None and ex.index is folded
        assert mutate.generation(folded) == mutate.generation(index) + 1
        assert ing.stats()["wal_bytes"] == 0
        _, i = srv.search(far, 5, timeout=TIMEOUT)
        assert i[:, 0].tolist() == [5000, 5001]
        _, i = srv.search(q[:1], 5, timeout=TIMEOUT)
        assert victim not in i
        # the swap rebuilt the table; steady traffic after it misses
        # nothing
        m1 = aot.executables().misses
        assert m1 > misses
        srv.search(q[:3], 5, timeout=TIMEOUT)
        assert aot.executables().misses == m1


def test_server_write_needs_an_ingest_tier(flat_index):
    ex = serving.Executor(CPU, "ivf_flat", flat_index, ks=(5,),
                          max_batch=4,
                          search_params=ivf_flat.SearchParams(n_probes=4))
    with serving.Server(ex, serving.ServerConfig(max_batch=4)) as srv:
        with pytest.raises(Exception, match="ingest"):
            srv.write(np.array([1]), np.zeros((1, DIM), np.float32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_write_after_warmup_is_served_through_the_replayed_graphs(
        dev, tmp_path):
    rng = np.random.default_rng(0)
    db = torch.from_numpy(rng.standard_normal((20_000, DIM)).astype(
        np.float32)).to(dev)
    res = DeviceResources(seed=0)
    index = ivf_pq.build(res, ivf_pq.IndexParams(n_lists=64, pq_dim=8), db)
    ex = serving.Executor(res, "ivf_pq", index, ks=(5,), max_batch=8,
                          search_params=ivf_pq.SearchParams(
                              n_probes=16, scan_mode="fused"))
    ing = _ingest(ting, tmp_path, res)
    srv = serving.Server(ex, serving.ServerConfig(max_batch=8,
                                                  max_wait_us=500))
    srv.attach_ingest(ing)
    ing.recover(base_index=index)
    with ing, srv:
        c0 = aot.executables().captures
        far = np.full((1, DIM), 40.0, np.float32)
        srv.write(np.array([90_000]), far)
        _, i = srv.search(far, 5, timeout=TIMEOUT)
        assert int(i[0, 0]) == 90_000
        srv.write(np.array([90_000]), op="delete")
        _, i = srv.search(far, 5, timeout=TIMEOUT)
        assert 90_000 not in i
        assert aot.executables().captures == c0 and ex.fallbacks == {}
