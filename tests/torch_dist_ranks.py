"""Rank-side checks of ``raft_tpu_torch.comms`` and ``raft_tpu_torch.
distributed``, run in gloo CPU ranks by ``raft_tpu_torch.comms.launch.
spawn`` from ``test_torch_comms.py`` and ``test_torch_distributed.py``.

Each function runs on every rank, in the same order, and returns plain
values (bools, numbers, strings, numpy arrays) that the test module
asserts one at a time.  This module imports torch, numpy and the port
only: the ranks never load jax.
"""

import torch
import torch.distributed as dist

from raft_tpu_torch import observability as obs
from raft_tpu_torch.comms import (CommsSession, local_handle,
                                  make_2d_session, self_test)
from raft_tpu_torch.comms.comms import op_t, status_t
from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.resilience import TransientFault, inject

SELF_TESTS = ("allreduce", "bcast", "reduce", "allgather", "gatherv",
              "reducescatter", "device_sendrecv", "comm_split",
              "isend_irecv")

# what comms_checks records of each collective on a 1-D group of four
# ranks and of a 2 x 2 grid, for the test to hold to the JAX package's
COLLECTIVES = ("allreduce sum", "allreduce prod", "allreduce min",
               "allreduce max", "bcast root 3", "reduce prod", "allgather",
               "gather", "reducescatter", "device_sendrecv", "device_send",
               "device_recv", "multicast", "sync_stream", "fan-in",
               "ring and swap")
GRID = ("2x2 sizes", "2x2 row allreduce", "2x2 col allgather",
        "2x2 row allgather", "2x2 grouped_by row allgather",
        "2x2 grouped_by col allgather")


def _error(fn):
    """The text of the error ``fn()`` raises, or None."""
    try:
        fn()
    except (RaftError, TypeError, ValueError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def _self_test(name):
    return getattr(self_test, "perform_test_comm_split"
                   if name == "comm_split" else f"perform_test_comms_{name}")


def _counted(fn):
    """The ``comms.*`` counters ``fn()`` records."""
    obs.reset()
    with obs.collecting():
        fn()
    snap = obs.snapshot()["counters"]
    obs.reset()
    return {k: v for k, v in snap.items() if k.startswith("comms")}


def comms_checks(rank, world):
    """Everything ``test_torch_comms.py`` asserts, from one rank."""
    out = {}
    s = CommsSession(axis_name="data", device="cpu").init()
    c = s.comms()
    out["size"] = c.get_size()
    out["rank"] = c.get_rank()
    out["backend"] = s.backend
    out["nccl_initialized"] = s.nccl_initialized
    for name in SELF_TESTS:
        out[f"self_test {name}"] = _self_test(name)(s)
    out["self_test bcast root 3"] = self_test.perform_test_comms_bcast(
        s, root=3)

    # the 2 x 2 grid: the nine checks over its "row" communicator, the
    # split along both axes, and collectives on each axis
    g = make_2d_session(2, 2, device="cpu").init()
    for name in SELF_TESTS:
        out[f"2x2 self_test {name}"] = _self_test(name)(g)
    row = g.comms()
    col = row.comm_split("col")
    same_row = row.comm_split(grouped_by="row")
    same_col = row.comm_split(grouped_by="col")
    me = torch.tensor(float(rank))
    out["2x2 sizes"] = (row.get_size(), col.get_size(), same_row.get_size(),
                        same_col.get_size())
    out["2x2 row allreduce"] = row.allreduce(torch.ones(())).numpy()
    out["2x2 col allgather"] = col.allgather(me).numpy()
    out["2x2 row allgather"] = row.allgather(me).numpy()
    out["2x2 grouped_by row allgather"] = same_row.allgather(me).numpy()
    out["2x2 grouped_by col allgather"] = same_col.allgather(me).numpy()
    g.destroy()

    # the collectives, each on this rank's inputs: test_torch_comms.py
    # gives the JAX package's Comms the same inputs on four mesh shards
    f = float(rank)
    x = torch.tensor([f + 1, 2.0])
    for op in (op_t.SUM, op_t.PROD, op_t.MIN, op_t.MAX):
        out[f"allreduce {op}"] = c.allreduce(x, op).numpy()
    out["bcast root 3"] = c.bcast(torch.tensor([f, 2 * f]), root=3).numpy()
    out["reduce prod"] = c.reduce(x, op=op_t.PROD).numpy()
    out["allgather"] = c.allgather(torch.tensor([f, -f])).numpy()
    ragged = torch.full((rank + 1, 2), f)
    counts = [r + 1 for r in range(world)]
    for name, fn in (("allgatherv", c.allgatherv), ("gatherv", c.gatherv)):
        got, got_counts = fn(ragged, counts)
        out[name] = got.numpy()
        out[f"{name} counts"] = got_counts
    out["gather"] = c.gather(torch.tensor([rank, 10 * rank],
                                          dtype=torch.int32)).numpy()
    out["reducescatter"] = c.reducescatter(
        torch.arange(2 * world, dtype=torch.float32).reshape(world, 2)
        * (rank + 1)).numpy()
    out["device_sendrecv"] = c.device_sendrecv(torch.tensor(f), dst=2,
                                               src=1).numpy()
    out["device_send"] = c.device_send(torch.tensor(f), 1).numpy()
    out["device_recv"] = c.device_recv(torch.tensor(f), 1).numpy()
    out["multicast"] = c.device_multicast_sendrecv(torch.tensor(f),
                                                   [0]).numpy()
    c.barrier()
    out["sync_stream"] = c.sync_stream()

    # fan-in p2p: evens send to their odd neighbour; evens receive
    # nothing (src -1 -> zeros)
    dst = [r + 1 if r % 2 == 0 else -1 for r in range(world)]
    src = [r - 1 if r % 2 == 1 else -1 for r in range(world)]
    (fan,) = c.waitall([c.isend(torch.tensor(f), dst, tag=0),
                        c.irecv(src, tag=0)])
    out["fan-in"] = fan.numpy()
    # a ring under tag 0 and a pair swap under tag 1, in one waitall
    ring = [(r + 1) % world for r in range(world)]
    back = [(r - 1) % world for r in range(world)]
    swap = [r ^ 1 for r in range(world)]
    got = c.waitall([c.isend(torch.tensor(f), ring, tag=0),
                     c.irecv(back, tag=0),
                     c.isend(torch.tensor(10 * f), swap, tag=1),
                     c.irecv(swap, tag=1)])
    out["ring and swap"] = torch.stack(got).numpy()

    # the pattern errors, raised alike on every rank before any message
    mine = torch.tensor(f)
    out["errors"] = {
        "isend dst range": _error(lambda: c.isend(mine, [world] * world)),
        "isend dst length": _error(lambda: c.isend(mine, [0])),
        "irecv src range": _error(lambda: c.irecv([-2] * world)),
        "irecv src length": _error(lambda: c.irecv([0])),
        "no send for tag": _error(lambda: c.waitall([c.irecv(back, tag=5)])),
        "two sends one tag": _error(lambda: c.waitall(
            [c.isend(mine, ring), c.isend(mine, ring), c.irecv(back)])),
        "patterns disagree": _error(lambda: c.waitall(
            [c.isend(mine, ring), c.irecv(ring)])),
        "send unclaimed": _error(lambda: c.waitall(
            [c.isend(mine, [1, -1, -1, -1]), c.irecv([-1] * world)])),
        "split both": _error(lambda: c.comm_split("data",
                                                  grouped_by="row")),
        "split neither": _error(lambda: c.comm_split()),
        "split grouped_by": _error(lambda: c.comm_split(
            grouped_by="diag")),
        "split unknown axis": _error(lambda: c.comm_split("col")),
        "reducescatter op": _error(lambda: c.reducescatter(
            torch.ones(world), op_t.MAX)),
        "reduce op": _error(lambda: c.allreduce(torch.ones(1), "xor")),
    }

    # counters: each op under its own name, executed calls with bytes
    out["counters allreduce"] = _counted(
        lambda: self_test.perform_test_comms_allreduce(s))
    out["counters reduce gather"] = _counted(lambda: (
        c.reduce(torch.ones(()), op=op_t.PROD),
        c.gather(torch.tensor(float(rank)))))
    out["counters p2p"] = _counted(lambda: (
        c.waitall([c.isend(mine, ring), c.irecv(back)]),
        c.device_send(mine, 1), c.barrier()))

    # the fault site fires before the collective, on every rank alike
    with inject("comms.allreduce", times=1):
        try:
            c.allreduce(torch.ones(()))
            out["fault"] = "no fault"
        except TransientFault as err:
            out["fault"] = type(err).__name__
    out["after fault"] = float(c.allreduce(torch.ones(())))

    # handles: local_handle, the comms slots, destroy
    h = local_handle(s.session_id, seed=3)
    out["local_handle"] = (h.comms_initialized(),
                           h.get_comms().axis_name, str(h.device))
    h.set_sub_comms("row", c)
    out["sub_comms"] = (h.get_sub_comms("row") is c,
                        _error(lambda: h.get_sub_comms("col")))
    out["unknown session"] = _error(lambda: local_handle("nonexistent"))
    sid = s.session_id
    s.destroy()
    out["destroyed"] = (s.nccl_initialized,
                        _error(lambda: local_handle(sid)))
    out["subgroup"] = _subgroup_check(rank)
    return out


def _subgroup_check(rank):
    """A session on a group of ranks 1 and 3 of the default group: ranks
    and broadcast roots are the group's."""
    sub = dist.new_group([1, 3])
    if rank not in (1, 3):
        return None
    s = CommsSession(group=sub, device="cpu").init()
    c = s.comms()
    got = c.bcast(torch.tensor(float(rank)), root=1)
    ok = self_test.perform_test_comms_isend_irecv(s)
    s.destroy()
    return c.get_rank(), c.get_size(), float(got), ok


def _knn_runs(handle, db, q, k, metrics):
    from raft_tpu_torch.distributed import knn as dist_knn

    return {int(m): tuple(t.numpy() for t in dist_knn.knn(
        handle, db, q, k, metric=m)) for m in metrics}


def distributed_checks(rank, world, data):
    """Everything ``test_torch_distributed.py`` asserts, from one rank:
    ``distributed.knn`` and ``kmeans`` at 2 shards (ranks 0 and 1 of a
    subgroup) and at 4 (every rank)."""
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.core.resources import DeviceResources
    from raft_tpu_torch.distributed import kmeans as dist_kmeans
    from raft_tpu_torch.distributed import knn as dist_knn

    pair = dist.new_group([0, 1])
    runs = {}
    sessions = {4: CommsSession(device="cpu").init()}
    if rank < 2:
        sessions[2] = CommsSession(group=pair, device="cpu").init()
    for shards, s in sessions.items():
        h = s.worker_handle(seed=0)
        out = {"knn": _knn_runs(h, data["db"], data["q"], data["k"],
                                data["metrics"])}
        params = KMeansParams(n_clusters=data["c0"].shape[0],
                              max_iter=data["max_iter"], tol=data["tol"],
                              init=InitMethod.Array)
        c, inertia, n_iter = dist_kmeans.fit(
            h, params, data["X"], centroids=torch.from_numpy(data["c0"]))
        out["fit"] = (c.numpy(), float(inertia), int(n_iter))
        out["predict"] = dist_kmeans.predict(h, params, data["X"],
                                             c).numpy()
        # a tensor database on the rank's device gives the same answer
        out["knn tensor"] = tuple(t.numpy() for t in dist_knn.knn(
            h, torch.from_numpy(data["db"]), data["q"], data["k"]))
        pp = KMeansParams(n_clusters=data["pp_clusters"],
                          max_iter=data["max_iter"], tol=data["tol"],
                          init=InitMethod.KMeansPlusPlus)
        c_pp, inertia_pp, n_pp = dist_kmeans.fit(h, pp, data["X_pp"])
        out["fit ++"] = (c_pp.numpy(), float(inertia_pp), int(n_pp))
        out["errors"] = {
            "uneven": _error(lambda: dist_knn.knn(
                h, data["db"][:-1], data["q"], data["k"])),
            "k past shard": _error(lambda: dist_knn.knn(
                h, data["db"], data["q"], data["db"].shape[0])),
            "uneven fit": _error(lambda: dist_kmeans.fit(
                h, params, data["X"][:-1], centroids=data["c0"])),
            "array without centroids": _error(lambda: dist_kmeans.fit(
                h, params, data["X"])),
        }
        runs[shards] = out
        s.destroy()
    plain = DeviceResources(seed=0, device="cpu")
    runs["no comms"] = {
        "knn": _error(lambda: dist_knn.knn(plain, data["db"], data["q"], 2)),
        "fit": _error(lambda: dist_kmeans.fit(
            plain, KMeansParams(n_clusters=2), data["X"])),
        "predict": _error(lambda: dist_kmeans.predict(
            plain, KMeansParams(n_clusters=2), data["X"], data["c0"])),
    }
    return runs



def fails_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def never_returns(rank, world):
    import time

    time.sleep(600)
