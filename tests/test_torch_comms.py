"""``raft_tpu_torch.comms`` on four gloo CPU ranks, against the JAX
package's ``raft_tpu.comms`` (``tests/test_comms.py`` runs it on the
virtual 8-device mesh).

The ranks are spawned once for the module (``comms.launch.spawn``, a
``file://`` rendezvous under ``tmp_path``, one torch thread each, a gloo
timeout of 60 s a collective and a deadline for the whole group); they run
every check of ``torch_dist_ranks.comms_checks`` and return the results,
which the tests below assert one check each.  Each collective's result on
rank r is held to shard r of the JAX package's ``Comms`` run in
``shard_map`` on four devices of the conftest's CPU mesh, with the same
inputs (a 1-D "data" axis, and a 2 x 2 ("row", "col") grid whose shards
are numbered row-major, as the port's ranks are).  The JAX package's
error texts come from its ``Comms`` called outside a trace, where its
pattern checks run before any collective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from raft_tpu.comms import CommsSession as JaxSession
from raft_tpu.comms import make_2d_session as jax_make_2d_session
from raft_tpu.comms.comms import Comms as JaxComms
from raft_tpu.comms.comms import op_t as jax_op_t
from raft_tpu.core.compat import shard_map
from raft_tpu.core.error import RaftError as JaxRaftError
from raft_tpu_torch.comms import launch

import torch_dist_ranks as ranks

WORLD = 4


def _counter(op, what):
    return ".".join(("comms", op, what))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("comms") / "rendezvous"
    return launch.spawn(ranks.comms_checks, WORLD, str(path),
                        timeout_s=180, collective_s=60)


@pytest.mark.parametrize("name", ranks.SELF_TESTS + ("bcast root 3",))
def test_self_tests_pass_on_four_ranks(results, name):
    assert [r[f"self_test {name}"] for r in results] == [True] * WORLD


@pytest.mark.parametrize("name", ranks.SELF_TESTS)
def test_self_tests_pass_on_a_2x2_grid(results, name):
    assert [r[f"2x2 self_test {name}"] for r in results] == [True] * WORLD


def _jax_per_shard(session, body):
    """``body()`` (a dict of arrays) on every shard of the session's mesh;
    each array comes back with the shards' results stacked on a leading
    axis, shard r (row-major on a grid) at r."""
    fn = shard_map(lambda: jax.tree.map(lambda a: jnp.asarray(a)[None],
                                        body()),
                   mesh=session.mesh, in_specs=(),
                   out_specs=P(tuple(session.mesh.axis_names)),
                   check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)())


def _jax_collectives(c):
    """The JAX ``Comms`` ``c`` (axis "data") on the inputs each rank of
    ``torch_dist_ranks.comms_checks`` gives the port."""
    n = c.get_size()
    counts = [r + 1 for r in range(n)]
    ring = [(r + 1) % n for r in range(n)]
    back = [(r - 1) % n for r in range(n)]
    swap = [r ^ 1 for r in range(n)]
    dst = [r + 1 if r % 2 == 0 else -1 for r in range(n)]
    src = [r - 1 if r % 2 == 1 else -1 for r in range(n)]

    def body():
        rank = jax.lax.axis_index("data")
        f = rank.astype(jnp.float32)
        x = jnp.stack([f + 1, jnp.float32(2)])
        out = {f"allreduce {op}": c.allreduce(x, op)
               for op in (jax_op_t.SUM, jax_op_t.PROD, jax_op_t.MIN,
                          jax_op_t.MAX)}
        out["bcast root 3"] = c.bcast(jnp.stack([f, 2 * f]), root=3)
        out["reduce prod"] = c.reduce(x, op=jax_op_t.PROD)
        out["allgather"] = c.allgather(jnp.stack([f, -f]))
        # rank r's r + 1 rows of r, and the zeros the port pads them with
        ragged = jnp.where((jnp.arange(n) < rank + 1)[:, None], f,
                           jnp.zeros((n, 2), jnp.float32))
        for name, fn in (("allgatherv", c.allgatherv),
                         ("gatherv", c.gatherv)):
            out[name], got_counts = fn(ragged, counts)
            out[f"{name} counts"] = jnp.asarray(got_counts)
        out["gather"] = c.gather(jnp.stack([rank, 10 * rank])
                                 .astype(jnp.int32))
        out["reducescatter"] = c.reducescatter(
            jnp.arange(2 * n, dtype=jnp.float32).reshape(n, 2) * (f + 1))
        out["device_sendrecv"] = c.device_sendrecv(f, dst=2, src=1)
        out["device_send"] = c.device_send(f, 1)
        out["device_recv"] = c.device_recv(f, 1)
        out["multicast"] = c.device_multicast_sendrecv(f, [0])
        (out["fan-in"],) = c.waitall([c.isend(f, dst, tag=0),
                                      c.irecv(src, tag=0)])
        out["ring and swap"] = jnp.stack(c.waitall(
            [c.isend(f, ring, tag=0), c.irecv(back, tag=0),
             c.isend(10 * f, swap, tag=1), c.irecv(swap, tag=1)]))
        return out

    return body


def _jax_grid():
    """The 2 x 2 grid's checks, as ``comms_checks`` makes them on the
    port's ``make_2d_session(2, 2)``."""
    row = JaxComms("row")
    col = row.comm_split("col")
    same_row = row.comm_split(grouped_by="row")
    same_col = row.comm_split(grouped_by="col")
    me = (jax.lax.axis_index("row") * 2
          + jax.lax.axis_index("col")).astype(jnp.float32)
    return {"2x2 sizes": jnp.asarray([row.get_size(), col.get_size(),
                                      same_row.get_size(),
                                      same_col.get_size()]),
            "2x2 row allreduce": row.allreduce(jnp.ones((), jnp.float32)),
            "2x2 col allgather": col.allgather(me),
            "2x2 row allgather": row.allgather(me),
            "2x2 grouped_by row allgather": same_row.allgather(me),
            "2x2 grouped_by col allgather": same_col.allgather(me)}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's result of each collective, stacked by shard."""
    devs = jax.devices()
    if len(devs) < WORLD:
        devs = jax.devices("cpu")
    flat = JaxSession(devices=devs[:WORLD], axis_name="data").init()
    grid = jax_make_2d_session(2, 2, devices=devs[:WORLD]).init()
    try:
        out = _jax_per_shard(flat, _jax_collectives(flat.comms()))
        out.update(_jax_per_shard(grid, _jax_grid))
    finally:
        flat.destroy()
        grid.destroy()
    out["sync_stream"] = np.full(WORLD, JaxComms("data").sync_stream())
    return out


def _assert_same(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("what", ranks.GRID)
def test_2x2_grid_splits_by_row_and_col(results, jax_results, what):
    """The 2 x 2 grid: sizes, an allreduce along "row", allgathers along
    each axis and through ``grouped_by``, as on the JAX package's
    ("row", "col") mesh."""
    for rank, r in enumerate(results):
        _assert_same(r[what], jax_results[what][rank], f"rank {rank}")


def test_session_reports_its_group(results):
    for rank, r in enumerate(results):
        assert (r["size"], r["rank"], r["backend"],
                r["nccl_initialized"]) == (WORLD, rank, "gloo", True)


@pytest.mark.parametrize("what", ranks.COLLECTIVES)
def test_collectives_give_the_jax_results(results, jax_results, what):
    for rank, r in enumerate(results):
        _assert_same(r[what], jax_results[what][rank], f"rank {rank}")


@pytest.mark.parametrize("name", ["allgatherv", "gatherv"])
def test_allgatherv_pads_and_returns_the_counts(results, jax_results, name):
    for rank, r in enumerate(results):
        _assert_same(r[name], jax_results[name][rank], f"rank {rank}")
        _assert_same(r[f"{name} counts"], jax_results[f"{name} counts"][rank],
                     f"rank {rank} counts")


def _jax_error(case):
    """The JAX package's error for one of the rank-side cases."""
    c = JaxComms("data", _size=WORLD)
    mine = jnp.float32(0)
    ring = [(r + 1) % WORLD for r in range(WORLD)]
    back = [(r - 1) % WORLD for r in range(WORLD)]
    calls = {
        "isend dst range": lambda: c.isend(mine, [WORLD] * WORLD),
        "isend dst length": lambda: c.isend(mine, [0]),
        "irecv src range": lambda: c.irecv([-2] * WORLD),
        "irecv src length": lambda: c.irecv([0]),
        "no send for tag": lambda: c.waitall([c.irecv(back, tag=5)]),
        "two sends one tag": lambda: c.waitall(
            [c.isend(mine, ring), c.isend(mine, ring), c.irecv(back)]),
        "patterns disagree": lambda: c.waitall(
            [c.isend(mine, ring), c.irecv(ring)]),
        "send unclaimed": lambda: c.waitall(
            [c.isend(mine, [1, -1, -1, -1]), c.irecv([-1] * WORLD)]),
        "split both": lambda: c.comm_split("data", grouped_by="row"),
        "split neither": lambda: c.comm_split(),
        "split grouped_by": lambda: c.comm_split(grouped_by="diag"),
        "reducescatter op": lambda: c.reducescatter(jnp.ones(WORLD), "max"),
        "reduce op": lambda: c.allreduce(jnp.ones(1), "xor"),
    }
    with pytest.raises((JaxRaftError, ValueError)) as err:
        calls[case]()
    name = "LogicError" if isinstance(err.value, JaxRaftError) else (
        type(err.value).__name__)
    return f"{name}: {err.value}"


@pytest.mark.parametrize("case", [
    "isend dst range", "isend dst length", "irecv src range",
    "irecv src length", "no send for tag", "two sends one tag",
    "patterns disagree", "send unclaimed", "split both", "split neither",
    "split grouped_by", "reducescatter op", "reduce op"])
def test_pattern_errors_are_the_jax_errors(results, case):
    """Every rank raises the JAX package's error, with its text, before
    any message moves."""
    expected = _jax_error(case)
    assert [r["errors"][case] for r in results] == [expected] * WORLD


def test_split_on_an_axis_the_grid_lacks_is_refused(results):
    for r in results:
        assert r["errors"]["split unknown axis"] == (
            "LogicError: comm_split: no axis 'col' in this communicator's "
            "grid ['data']")


@pytest.mark.parametrize("case", ["allreduce", "reduce gather", "p2p"])
def test_counters_count_each_op_under_its_own_name(results, case):
    expected = {
        "allreduce": {_counter("allreduce", "calls"): 1,
                      _counter("allreduce", "bytes"): 4},
        "reduce gather": {_counter("reduce", "calls"): 1,
                          _counter("reduce", "bytes"): 4,
                          _counter("gather", "calls"): 1,
                          _counter("gather", "bytes"): 4},
        "p2p": {_counter("isend", "calls"): 1,
                _counter("isend", "bytes"): 4,
                _counter("device_send", "calls"): 1,
                _counter("device_send", "bytes"): 4,
                _counter("barrier", "calls"): 1},
    }[case]
    assert [r[f"counters {case}"] for r in results] == [expected] * WORLD


def test_fault_site_fires_before_the_collective(results):
    """An injected ``comms.allreduce`` fault raises on every rank before
    the collective starts, so the next allreduce still pairs up."""
    assert [(r["fault"], r["after fault"]) for r in results] == [
        ("TransientFault", float(WORLD))] * WORLD


def test_local_handle_and_destroy(results):
    for r in results:
        assert r["local_handle"] == (True, "data", "cpu")
        assert r["sub_comms"] == (
            True, "LogicError: no sub-communicator 'col'")
        assert r["unknown session"] == (
            "LogicError: no comms session 'nonexistent'")
        initialized, error = r["destroyed"]
        assert not initialized and error.startswith(
            "LogicError: no comms session '")


def test_a_session_on_a_subgroup_uses_its_ranks(results):
    """Ranks 1 and 3 in a group of their own: group ranks 0 and 1, root 1
    is global rank 3."""
    assert [r["subgroup"] for r in results] == [
        None, (0, 2, 3.0, True), None, (1, 2, 3.0, True)]


def test_launch_names_the_rank_that_failed(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        launch.spawn(ranks.fails_on_rank_one, 2, str(tmp_path / "rdv"),
                     timeout_s=120)
    assert "rank one fails on purpose" in str(err.value)


def test_launch_kills_ranks_past_the_deadline(tmp_path):
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0\] of 1"):
        launch.spawn(ranks.never_returns, 1, str(tmp_path / "rdv"),
                     timeout_s=4)
