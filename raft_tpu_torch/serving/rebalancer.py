"""Crash-safe background rebalancer over the mutable IVF indexes (port of
``raft_tpu.serving.rebalancer``).

Long-lived mutable indexes degrade two ways: tombstones from ``delete``
accumulate scan overhead (every probe still streams and masks the dead
slots), and ``extend`` drifts rows into whichever coarse lists happened
to be nearest, leaving some lists far fuller than others (worst-case
probe cost is set by the fullest list).  The rebalancer repairs both in
the background, one staged, checkpointed, verification-gated pass at a
time:

``plan``
    Measure the damage: per-list live sizes, the tombstoned fraction of
    occupied slots.  Nothing to repair -> the pass is a no-op.
``recluster``
    For every overfull list (live size > ``overfull_factor`` x mean),
    pull its live rows (IVF-Flat: the stored vectors; IVF-PQ: the
    decoded ``center + residual`` reconstructions rotated back to input
    space), ``delete`` them and ``extend`` them back under their
    original ids — extend's nearest-center assignment IS the
    re-clustering step, spreading drifted rows over the current
    centroids.
``compact``
    Past ``dead_fraction`` (or after any recluster, whose deletes
    create tombstones by construction), rewrite every list live-rows
    first and drop the dead slots, shrinking capacity back down.

Each stage checkpoints the full serialized index through
:class:`~raft_tpu_torch.resilience.checkpoint.CheckpointManager` (atomic
tmp+fsync+rename, CRC-protected).  A crash mid-pass leaves the serving
tier on the last good generation — mutations build NEW snapshots, they
never touch the served one — and :meth:`Rebalancer.resume` either
finishes the pass from the furthest checkpoint or rolls back to the
checkpointed base; both paths re-run the gate.

The gate: no candidate index is ever swapped in before it passes
``integrity.verify`` (at ``verify_level``, with the id-space bound
computed from the candidate itself — delete + compact makes the live id
space sparse, so ``sum(list_sizes)`` is not the bound) AND the recall
canary ``health_check`` when the index carries canaries.  Swap-in goes
through ``Server.swap_index``: a fully warmed replacement executable
table published atomically, in-flight readers pinned on the generation
they started on.

Fault sites (``resilience.faults``): ``rebalance.plan`` /
``rebalance.recluster`` / ``rebalance.compact`` / ``rebalance.verify`` /
``rebalance.swap``, plus the manager's own ``checkpoint.save`` /
``checkpoint.load`` — the crash-recovery tests kill a pass at every
one of these boundaries and assert resume-or-rollback lands on a
verify-clean, canary-passing index.
"""

from __future__ import annotations

import dataclasses
import io
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core.error import expects, not_ported_stub
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.integrity.verify import verify as _verify_index
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.resilience.checkpoint import CheckpointManager, as_manager


@dataclasses.dataclass
class RebalanceConfig:
    """Rebalancer knobs.

    ``dead_fraction`` is the tombstone budget: compaction triggers when
    dead/(live+dead) occupied slots exceeds it.
    ``overfull_factor`` flags lists for re-clustering when their live
    size exceeds that multiple of the mean live list size.
    ``max_lists_per_pass`` bounds one pass's recluster work so the
    background thread stays incremental (0 = no bound).
    """

    dead_fraction: float = 0.2
    overfull_factor: float = 2.0
    max_lists_per_pass: int = 8
    interval_s: float = 30.0
    verify_level: str = "statistical"


class Rebalancer:
    """Staged, checkpointed, gated maintenance over one mutable index.

    ``checkpoint`` (a path or :class:`CheckpointManager`) enables crash
    safety; without it the pass still runs gated, just without resume.
    ``server`` (a :class:`~raft_tpu_torch.serving.server.Server` or bare
    executor with ``swap_index``) receives every accepted generation.
    """

    def __init__(self, res, index, *,
                 config: Optional[RebalanceConfig] = None,
                 checkpoint: Optional[Union[str, CheckpointManager]] = None,
                 server=None, ingest=None) -> None:
        expects(isinstance(index, (ivf_flat.Index, ivf_pq.Index)),
                "rebalancer: only IVF-Flat / IVF-PQ indexes rebalance "
                "(CAGRA's delete shim requires a rebuild to reclaim rows)")
        self.res = res
        self.config = config or RebalanceConfig()
        self.checkpoint = as_manager(checkpoint)
        self.server = server
        # streaming-ingest compaction hook: each background pass first
        # offers the ingest tier a fold (its own checkpointed, gated
        # stage — see serving/ingest.py); a published fold moves this
        # rebalancer's base forward so a later pass never swaps a
        # pre-fold generation back in
        self.ingest = ingest
        self.last_good = index
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats: Dict[str, int] = {
            "passes": 0, "swaps": 0, "rollbacks": 0, "noops": 0,
            "errors": 0, "reclustered_rows": 0, "compactions": 0}

    # ---- introspection --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self._stats)
        out["generation"] = _mutate.generation(self.last_good)
        out["dead_fraction"] = _mutate.dead_fraction(self.last_good)
        return out

    # ---- one staged pass ------------------------------------------------

    def run_once(self):
        """One full pass: plan -> recluster -> compact -> gate -> swap.
        Returns the index now serving (a new generation when repair work
        was accepted, ``last_good`` unchanged otherwise).  An injected
        fault or crash mid-pass propagates — the served index is
        untouched; call :meth:`resume` afterwards."""
        with self._lock:
            return self._run_once_locked()

    def _run_once_locked(self):
        index = self.last_good
        self._stats["passes"] += 1
        faults.maybe_fail("rebalance.plan")
        overfull, dead = self._plan(index)
        if not overfull.size and dead < self.config.dead_fraction:
            self._stats["noops"] += 1
            return self.last_good
        self._save_stage("base", index)

        faults.maybe_fail("rebalance.recluster")
        moved = 0
        work = index
        if overfull.size:
            work, moved = self._recluster(index, overfull)
            self._stats["reclustered_rows"] += moved
        self._save_stage("recluster", work)

        faults.maybe_fail("rebalance.compact")
        if moved or _mutate.dead_fraction(work) >= self.config.dead_fraction:
            mod = self._mod(work)
            work = mod.compact(self.res, work)
            self._stats["compactions"] += 1
        self._save_stage("compact", work)

        return self._gate_and_swap(work)

    # ---- streaming-ingest compaction hook -------------------------------

    def maybe_fold_ingest(self):
        """Offer the attached ingest tier a threshold-triggered memtable
        fold (the LSM compaction stage); a published fold becomes this
        rebalancer's new base.  No-op without an ingest tier.  Returns
        the folded index or None."""
        if self.ingest is None:
            return None
        folded = self.ingest.maybe_fold()
        if folded is not None:
            with self._lock:
                self.last_good = folded
        return folded

    # ---- crash recovery -------------------------------------------------

    def resume(self):
        """Recover after a crash / injected fault: finish the pass from
        the furthest completed checkpoint stage (re-running the gate), or
        roll back to the checkpointed base generation when the candidate
        cannot be recovered or fails the gate.  Either way the result is
        a gated index and a cleared checkpoint directory — an unverified
        candidate is never served."""
        with self._lock:
            return self._resume_locked()

    def _resume_locked(self):
        ck = self.checkpoint
        if ck is None or not ck.completed:
            return self.last_good
        done = ck.completed
        for stage in ("compact", "recluster"):
            if stage in done:
                try:
                    cand = self._load_stage(stage)
                    return self._gate_and_swap(cand)
                except Exception:  # noqa: BLE001 - any failure -> roll back
                    self._stats["errors"] += 1
                    break
        # rollback: the base checkpoint is the last generation that
        # passed a gate; re-serve it and drop the partial pass
        if "base" in done:
            try:
                base = self._load_stage("base")
                if _mutate.generation(base) != _mutate.generation(
                        self.last_good):
                    self.last_good = base
                    self._swap(base)
            except Exception:  # noqa: BLE001 - keep serving in-memory good
                self._stats["errors"] += 1
        ck.clear()
        self._stats["rollbacks"] += 1
        # a rollback means a candidate generation was abandoned — exactly
        # the state transition a post-mortem wants on the anomaly timeline
        _flight.record_event("rebalance.rollback",
                             generation=_mutate.generation(self.last_good),
                             errors=self._stats["errors"])
        return self.last_good

    # ---- stages ---------------------------------------------------------

    def _plan(self, index):
        live = _mutate.live_sizes(index.list_indices).cpu().numpy()
        dead = _mutate.dead_fraction(index)
        filled = live[live > 0]
        if not filled.size:
            return np.empty(0, np.int64), dead
        mean = float(filled.mean())
        overfull = np.nonzero(live > self.config.overfull_factor
                              * max(mean, 1.0))[0]
        cap = self.config.max_lists_per_pass
        if cap and overfull.size > cap:
            # fullest first: bounded passes repair the worst skew first
            overfull = overfull[np.argsort(-live[overfull])][:cap]
        return overfull, dead

    def _recluster(self, index, overfull):
        """delete + re-extend the overfull lists' live rows: extend's
        nearest-center assignment redistributes them over the CURRENT
        centroids (adaptive centers have drifted since these rows were
        placed), and the original ids ride along unchanged."""
        rows, ids = self._gather_rows(index, overfull)
        if not ids.size:
            return index, 0
        mod = self._mod(index)
        work = mod.delete(self.res, index, torch.from_numpy(ids))
        work = mod.extend(self.res, work, torch.from_numpy(rows),
                          torch.from_numpy(ids))
        return work, int(ids.size)

    def _gather_rows(self, index, overfull):
        # only the overfull lists leave the device
        sel_lists = torch.as_tensor(np.asarray(overfull, np.int64),
                                    device=index.list_indices.device)
        li = index.list_indices[sel_lists].cpu().numpy()
        if isinstance(index, ivf_flat.Index):
            data = index.list_data[sel_lists].float().cpu().numpy()
        else:
            recon = (index.list_recon[sel_lists]
                     if index.list_recon is not None
                     else ivf_pq._decode_lists(
                         index.codebooks[sel_lists] if
                         index.codebook_kind == ivf_pq.CodebookKind.
                         PER_CLUSTER else index.codebooks,
                         index.list_codes[sel_lists], index.pq_dim,
                         index.pq_bits, index.codebook_kind))
            recon = recon.float().cpu().numpy()
            rot = index.rotation.float().cpu().numpy()
            centers = index.centers[sel_lists].float().cpu().numpy()
        out_rows, out_ids = [], []
        for j in range(len(overfull)):
            sel = li[j] >= 0
            if not sel.any():
                continue
            out_ids.append(li[j][sel].astype(np.int32))
            if isinstance(index, ivf_flat.Index):
                out_rows.append(np.asarray(data[j][sel], np.float32))
            else:
                # decoded residual + center live in rotated space; the
                # rotation is orthonormal (dim, rot_dim), so @ rotation.T
                # maps the reconstruction back to input space (exact
                # inverse when rot_dim == dim, the default)
                out_rows.append((recon[j][sel] + centers[j][None]) @ rot.T)
        if not out_ids:
            return (np.empty((0, int(index.dim)), np.float32),
                    np.empty(0, np.int32))
        return (np.concatenate(out_rows).astype(np.float32),
                np.concatenate(out_ids))

    # ---- the gate -------------------------------------------------------

    def _gate_and_swap(self, cand):
        faults.maybe_fail("rebalance.verify")
        _verify_index(cand, self.config.verify_level, res=self.res,
                      n_rows=self._id_span(cand))
        if getattr(cand, "canaries", None) is not None:
            _canary.health_check(self.res, cand, raise_on_fail=True)
        faults.maybe_fail("rebalance.swap")
        self.last_good = cand
        self._swap(cand)
        if self.checkpoint is not None:
            self.checkpoint.clear()
        self._stats["swaps"] += 1
        if obs.enabled():
            obs.registry().counter("rebalance.swaps").inc()
        return cand

    def _swap(self, cand) -> None:
        if self.server is None:
            return
        ex = getattr(self.server, "executor", self.server)
        if getattr(ex, "index", None) is not cand:
            self.server.swap_index(cand)

    @staticmethod
    def _id_span(index) -> int:
        """The candidate's true id-space bound: max decoded source id
        (live or tombstoned) + 1.  After delete + compact the live id
        space is sparse, so ``sum(list_sizes)`` under-counts — verify's
        default convention does not apply to rebalanced snapshots."""
        li = index.list_indices.cpu().numpy()
        dec = np.where(li <= -2, -li.astype(np.int64) - 2,
                       li.astype(np.int64))
        vals = dec[(li >= 0) | (li <= -2)]
        return int(vals.max()) + 1 if vals.size else 0

    # ---- checkpoint plumbing --------------------------------------------

    def _mod(self, index):
        return ivf_flat if isinstance(index, ivf_flat.Index) else ivf_pq

    def _save_stage(self, stage: str, index) -> None:
        if self.checkpoint is None:
            return
        mod = self._mod(index)
        buf = io.BytesIO()
        mod.serialize(self.res, buf, index)
        self.checkpoint.save(stage, {
            "index": np.frombuffer(buf.getvalue(), np.uint8),
            "kind": np.frombuffer(
                ("ivf_flat" if mod is ivf_flat else "ivf_pq").encode(),
                np.uint8),
            "generation": np.asarray([_mutate.generation(index)],
                                     np.int64)})

    def _load_stage(self, stage: str):
        arrays = self.checkpoint.load(stage)
        kind = bytes(arrays["kind"]).decode()
        mod = ivf_flat if kind == "ivf_flat" else ivf_pq
        idx = mod.deserialize(self.res, io.BytesIO(bytes(arrays["index"])))
        idx.generation = int(arrays["generation"][0])
        return idx

    # ---- background thread ----------------------------------------------

    def start(self) -> "Rebalancer":
        """Run :meth:`run_once` every ``config.interval_s`` on a daemon
        thread until :meth:`stop`.  A failing pass (including injected
        faults) is recorded and the loop continues serving ``last_good``
        — the background thread never propagates into request threads."""
        expects(self._thread is None, "rebalancer: already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.maybe_fold_ingest()
                    self.run_once()
                except Exception:  # noqa: BLE001 - keep last_good serving
                    self._stats["errors"] += 1

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="raft-tpu-torch-rebalancer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def __enter__(self) -> "Rebalancer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


rebalance_routed = not_ported_stub("serving.rebalancer", "rebalance_routed",
                                   "distributed (item 7)")
