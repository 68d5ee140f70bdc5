"""Durable streaming ingest: WAL-backed writes into the delta tier (port
of ``raft_tpu.serving.ingest``; the WAL is byte for byte the JAX
package's, so either package replays a log the other wrote).

The foreground write path the read side has lacked: ``Server.write()``
appends upsert/delete records to a write-ahead log and acknowledges
only after the record is fsync-durable, applies them to the
always-mutable :class:`~raft_tpu_torch.neighbors.delta.Memtable` (searched
alongside the main index — see ``Executor.attach_delta``), and
periodically **folds** the memtable into the main index as a
checkpointed, gated compaction that truncates the WAL only after the
swapped-in generation lands.  An acknowledged write survives a process
kill at any instruction boundary — the crash-safety contract the
rebalancer established for background maintenance, extended to
every foreground write.

WAL format::

    <wal_dir>/wal.log        # append-only stream of framed records
    <wal_dir>/fold/          # CheckpointManager dir for the fold stage

Each record rides the RTIE envelope conventions from
:mod:`raft_tpu_torch.core.serialize` — magic ``RTIE`` | u16 version |
u64 payload length | u32 CRC32(payload) — wrapping a payload of::

    u64 lsn | u8 op (1=upsert, 2=delete) | u32 n_rows | u32 dim |
    n_rows * i64 ids | n_rows * dim * f32 vectors   (upserts only)

Appends are single ``write()`` syscalls on an unbuffered fd (atomic
append), fsync is **group-committed**: concurrent writers share one
fsync covering every record appended so far, so the fsync cost
amortizes across the write burst while every ack stays strictly
durable.  Rows become *searchable* when applied to the memtable —
before the fsync — so visibility latency is decoupled from durability
latency; the ack still waits for the fsync.

Replay (:meth:`IngestServer.recover`) scans the log front to back:

- a record whose declared extent runs past EOF, a short/zero-filled
  header, or a CRC mismatch **on the final record** is a torn tail —
  physically truncated (fsync'd) and replay continues from the intact
  prefix;
- a CRC mismatch (or frame garbage) with intact records beyond it is
  real corruption — :class:`~raft_tpu_torch.core.serialize.CorruptIndexError`
  naming the byte offset, never a silent skip;
- replayed records re-enter :meth:`Memtable.apply`, the same code the
  live path runs, with lsn-idempotence — recovered state is
  bit-identical to any other replay of the same bytes.

Fold lifecycle (crash-safe, in order): snapshot payload at fold LSN F →
``delete`` + ``extend`` on the main index under ONE generation bump
(the upsert pattern) → integrity verify + recall canary gate → durable
``commit`` checkpoint (candidate + F) → publish via
``Server.swap_index`` → WAL truncation → memtable reset → checkpoint
clear.  A kill before the commit marker rolls back (base index + full
WAL replay); after it, :meth:`recover` rolls forward (the committed
candidate is the main index, the WAL truncation completes).  Writes
are blocked for the duration of a fold — bounded by the memtable size,
which backpressure bounds in turn.

Admission control (BEFORE any WAL byte): bounded WAL lag
(``max_wal_bytes``) and memtable rows (``max_memtable_rows``) shed
with typed :class:`~raft_tpu_torch.serving.admission.Overloaded`; per-tenant
write token buckets (rows/s) shed with :class:`QuotaExceeded`; a
brownout rung with ``shed_best_effort_writes=True`` sheds best-effort
tenants' writes with :class:`BrownedOut` while active.

Fault sites (:mod:`raft_tpu_torch.resilience.faults`, incl. ``delay_at``):
``ingest.append`` / ``ingest.fsync`` / ``ingest.apply`` /
``ingest.fold`` / ``ingest.truncate`` — the kill-matrix tests inject a
failure at every one and assert recovery.  Counters:
``serving.ingest.{appended,acked,replayed,folds,truncations}`` plus the
``serving.ingest.shed.*`` family; ``serving.ingest.visibility`` is the
append→searchable latency histogram; fold / replay / backpressure
transitions land flight-recorder events.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.serialize import CorruptIndexError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.integrity import canary as _canary
from raft_tpu_torch.integrity.verify import verify as _verify_index
from raft_tpu_torch.neighbors import delta as _delta
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import mutate as _mutate
from raft_tpu_torch.observability import flight as _flight
from raft_tpu_torch.observability import trace as _trace
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.resilience.checkpoint import CheckpointManager, atomic_write
from raft_tpu_torch.serving.admission import (
    BrownedOut,
    Overloaded,
    QuotaExceeded,
    TokenBucket,
)

_WAL_FILE = "wal.log"
_FOLD_DIR = "fold"
_FOLD_STAGE = "commit"
# payload head: u64 lsn | u8 op | u32 n_rows | u32 dim
_REC_HEAD = struct.Struct("<QBII")
_OPS = {"upsert": _delta.OP_UPSERT, "delete": _delta.OP_DELETE}


def _count(name: str) -> None:
    if obs.enabled():
        obs.registry().counter(name).inc()


def _gauge(name: str, value: float) -> None:
    if obs.enabled():
        obs.registry().gauge(name).set(value)


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

def encode_record(lsn: int, op: int, ids: np.ndarray,
                  vectors: Optional[np.ndarray]) -> bytes:
    """One framed WAL record: RTIE envelope around the payload above."""
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    dim = 0
    body = [_REC_HEAD.pack(lsn, op, ids.size, 0), ids.tobytes()]
    if op == _delta.OP_UPSERT:
        vecs = np.ascontiguousarray(vectors, np.float32)
        dim = int(vecs.shape[1])
        body[0] = _REC_HEAD.pack(lsn, op, ids.size, dim)
        body.append(vecs.tobytes())
    payload = b"".join(body)
    out = io.BytesIO()
    ser.write_envelope(out, payload)
    return out.getvalue()


def _decode_payload(payload: bytes, offset: int) -> _delta.Record:
    """Payload bytes -> Record; malformed structure under a VALID CRC is
    real corruption and raises naming the record's byte offset."""
    if len(payload) < _REC_HEAD.size:
        raise CorruptIndexError(
            f"corrupt WAL record at byte offset {offset}: payload shorter "
            f"than the record head ({len(payload)} bytes)")
    lsn, op, n, dim = _REC_HEAD.unpack_from(payload, 0)
    if op not in (_delta.OP_UPSERT, _delta.OP_DELETE):
        raise CorruptIndexError(
            f"corrupt WAL record at byte offset {offset}: unknown op {op}")
    want = _REC_HEAD.size + 8 * n + (4 * n * dim if op == _delta.OP_UPSERT
                                     else 0)
    if len(payload) != want or (op == _delta.OP_DELETE and dim != 0):
        raise CorruptIndexError(
            f"corrupt WAL record at byte offset {offset}: payload length "
            f"{len(payload)} does not match op={op} n={n} dim={dim}")
    ids = np.frombuffer(payload, np.int64, n, _REC_HEAD.size)
    vectors = None
    if op == _delta.OP_UPSERT:
        vectors = np.frombuffer(payload, np.float32, n * dim,
                                _REC_HEAD.size + 8 * n).reshape(n, dim)
    return _delta.Record(lsn=int(lsn), op=int(op), ids=ids, vectors=vectors)


def scan_wal(data: bytes) -> Tuple[list, int]:
    """Scan a WAL byte stream; returns ``(records, good_end)`` where
    ``good_end`` is the offset of the first torn byte (== len(data) for
    a clean log).  Mid-log corruption — a bad frame or CRC mismatch
    with intact bytes beyond the record's declared extent — raises
    :class:`CorruptIndexError` with the record's byte offset; only
    damage that reaches EOF is a (repairable) torn tail."""
    records = []
    off, n = 0, len(data)
    head = ser._ENVELOPE_HEADER
    while off < n:
        if n - off < head.size:
            return records, off                      # torn header at EOF
        magic, version, length, crc = head.unpack_from(data, off)
        if magic != ser._ENVELOPE_MAGIC or version != ser._ENVELOPE_VERSION:
            if data.find(ser._ENVELOPE_MAGIC, off) == -1:
                return records, off                  # garbage tail only
            raise CorruptIndexError(
                f"corrupt WAL: bad record frame at byte offset {off} "
                f"(magic {magic!r}, version {version})")
        end = off + head.size + length
        if end > n:
            return records, off                      # record runs past EOF
        payload = data[off + head.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            if end == n:
                return records, off                  # torn final record
            raise CorruptIndexError(
                f"corrupt WAL: CRC mismatch in record at byte offset {off}")
        records.append(_decode_payload(payload, off))
        off = end
    return records, off


class WriteAheadLog:
    """Append-only framed record log with group-commit durability.

    Appends are single unbuffered ``write()`` calls (atomic append, no
    Python-level buffer to race a concurrent fsync); :meth:`sync` is
    one fsync covering everything appended so far.  Callers serialize
    appends (the ingest lock) — this class only owns the fd."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "ab", buffering=0)
        self._size = self._f.seek(0, os.SEEK_END)

    @property
    def size_bytes(self) -> int:
        return self._size

    def append(self, record: bytes) -> None:
        faults.maybe_fail("ingest.append")
        self._f.write(record)
        self._size += len(record)

    def sync(self) -> None:
        faults.maybe_fail("ingest.fsync")
        os.fsync(self._f.fileno())

    def truncate_all(self) -> None:
        """Atomically reset the log to empty (post-fold: every record is
        folded into the committed candidate)."""
        faults.maybe_fail("ingest.truncate")
        self._f.close()
        atomic_write(self.path, b"")
        self._f = open(self.path, "ab", buffering=0)
        self._size = 0
        _count("serving.ingest.truncations")

    def repair_tail(self, good_end: int) -> int:
        """Truncate a torn tail at ``good_end``; returns dropped bytes.
        The truncation is fsync'd through the same ``ingest.fsync``
        fault site as the append path — an injected fsync failure
        during replay propagates cleanly and the next recover retries."""
        dropped = self._size - good_end
        if dropped <= 0:
            return 0
        self._f.truncate(good_end)
        self.sync()
        self._size = good_end
        return dropped

    def read_bytes(self) -> bytes:
        with open(self.path, "rb") as f:
            return f.read()

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# the ingest server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IngestConfig:
    """Write-path knobs.

    ``memtable_capacity`` is the initial shape-static scan capacity
    (regrow doubles it under a generation bump); ``max_memtable_rows``
    and ``max_wal_bytes`` are the backpressure bounds — beyond either,
    writes shed with :class:`Overloaded` until a fold drains the tier.
    ``write_quotas`` maps tenant -> (rate_rows_per_s, burst_rows).
    ``fold_rows`` / ``fold_tombstones`` are the ``maybe_fold``
    size thresholds; ``fold_replay_debt_rows`` / ``fold_visibility_lag_s``
    are the WAL-lag / visibility-target triggers (0 disables
    any trigger; the rebalancer hook calls ``maybe_fold`` each pass).
    """

    wal_dir: str = "ingest-wal"
    memtable_capacity: int = 1024
    tomb_capacity: int = 1024
    max_memtable_rows: int = 8192
    max_wal_bytes: int = 64 << 20
    fold_rows: int = 0
    fold_tombstones: int = 0
    #: fold when the WAL replay debt (rows logged since the last fold —
    #: the rows a recovery would have to replay) reaches this bound
    #: (0 disables)
    fold_replay_debt_rows: int = 0
    #: fold when the OLDEST unfolded record has been pinned in the
    #: delta tier longer than this many seconds (0 disables) — the
    #: visibility-target trigger: it bounds both recovery replay time
    #: and how long the memtable merge carries a row
    fold_visibility_lag_s: float = 0.0
    write_quotas: Optional[Dict[str, Tuple[float, float]]] = None
    verify_level: str = "statistical"


class IngestServer:
    """The durable write path over one :class:`Memtable` + main index.

    Standalone (tests, offline loaders) or bound to a serving
    :class:`~raft_tpu_torch.serving.server.Server` via ``server.attach_ingest``
    — binding attaches the memtable's device view to the executor's
    delta-merge seam and routes fold publications through
    ``Server.swap_index``.  Call :meth:`recover` before serving: it
    rolls an interrupted fold forward or back and replays the WAL."""

    def __init__(self, res, config: Optional[IngestConfig] = None, *,
                 dim: int, metric=DistanceType.L2Expanded,
                 clock=time.monotonic) -> None:
        self.res = res
        self.config = config or IngestConfig()
        self.memtable = _delta.Memtable(
            dim, capacity=self.config.memtable_capacity,
            tomb_capacity=self.config.tomb_capacity, metric=metric,
            device=getattr(res, "device", "cuda"))
        os.makedirs(self.config.wal_dir, exist_ok=True)
        self._ck = CheckpointManager(
            os.path.join(self.config.wal_dir, _FOLD_DIR))
        self._wal: Optional[WriteAheadLog] = None
        self._clock = clock
        self._buckets = {t: TokenBucket(r, b, clock)
                         for t, (r, b) in
                         (self.config.write_quotas or {}).items()}
        self._server = None
        self._brownout = None
        self._index = None            # served index when no server is bound
        self._lsn = 0
        self._lock = threading.Lock()        # append order + memtable apply
        self._fold_lock = threading.Lock()
        self._sync_cond = threading.Condition()
        self._synced_lsn = 0
        self._sync_busy = False
        # group-commit failure fence: bumped when a group fsync fails,
        # with the exception retained so every rider of the failed
        # group re-raises it instead of riding a later, luckier fsync
        self._sync_epoch = 0
        self._sync_exc: Optional[BaseException] = None
        self._backpressured = False
        self._recovered = False
        # fold-trigger state: rows a recovery would replay
        # and the append time of the oldest unfolded record
        self._replay_debt_rows = 0
        self._oldest_pending_ts: Optional[float] = None

    # ---- wiring ----------------------------------------------------------

    @property
    def wal_path(self) -> str:
        return os.path.join(self.config.wal_dir, _WAL_FILE)

    def bind(self, server) -> None:
        """Attach to a serving Server (call via ``server.attach_ingest``
        BEFORE ``server.start()`` — the delta merge joins every warmed
        shape)."""
        self._server = server
        self._brownout = server.brownout
        server.executor.attach_delta(self.memtable.device_view)

    def _current_index(self):
        if self._server is not None:
            return self._server.executor.index
        return self._index

    def _publish(self, cand) -> None:
        if self._server is not None:
            self._server.swap_index(cand)
        self._index = cand

    # ---- recovery --------------------------------------------------------

    def recover(self, base_index=None):
        """Roll an interrupted fold forward/back, repair a torn WAL
        tail, replay the intact records into the memtable, and return
        the index to serve (the committed fold candidate when one
        landed, else ``base_index``).  Idempotent; must run before the
        first :meth:`write`."""
        main = base_index if base_index is not None else self._index
        rolled_forward = False
        if self._ck.has(_FOLD_STAGE):
            try:
                cand, fold_lsn = self._load_fold()
                # committed fold: the candidate IS the main index; finish
                # the interrupted truncation (every logged record <= F is
                # folded in) and retire the checkpoint
                self._open_wal()
                self._wal.truncate_all()
                self.memtable.reset()
                self._ck.clear()
                main = cand
                rolled_forward = True
                _flight.record_event("serving.ingest.replay",
                                     rolled_forward=True, fold_lsn=fold_lsn,
                                     generation=_mutate.generation(cand))
            except CorruptIndexError:
                # torn/corrupt candidate: abandon the fold, full replay
                self._ck.clear()
        elif self._ck.completed:
            # fold died before its commit marker: roll back (the WAL
            # still holds every record; the base index is untouched)
            self._ck.clear()
        self._open_wal()
        if not rolled_forward:
            data = self._wal.read_bytes()
            records, good_end = scan_wal(data)
            dropped = self._wal.repair_tail(good_end)
            replayed = 0
            for rec in records:
                if self.memtable.apply(rec):
                    replayed += 1
                    _count("serving.ingest.replayed")
            self._lsn = max((r.lsn for r in records), default=0)
            self._synced_lsn = self._lsn
            self._replay_debt_rows = int(
                sum(r.ids.size for r in records))
            self._oldest_pending_ts = (self._clock() if records else None)
            if records or dropped:
                _flight.record_event("serving.ingest.replay",
                                     rolled_forward=False, records=replayed,
                                     truncated_bytes=dropped,
                                     last_lsn=self._lsn)
        self._index = main
        self._recovered = True
        return main

    def _open_wal(self) -> None:
        if self._wal is None:
            self._wal = WriteAheadLog(self.wal_path)

    # ---- the write path --------------------------------------------------

    def write(self, ids, vectors=None, *, op: str = "upsert",
              tenant: str = "default") -> int:
        """Append one upsert/delete record, fsync (group-committed),
        apply to the memtable, and return the record's LSN — the ack.
        A raised exception means NOT acknowledged: the record may or may
        not be durable and the caller must retry (upserts/deletes are
        idempotent by id).  Sheds with :class:`Overloaded` subclasses
        before touching the WAL."""
        expects(self._recovered,
                "ingest: recover() must run before the first write")
        t0 = self._clock()
        # per-write trace (parity with the read path): adopt an
        # ambient recorder when the caller already minted one, else mint
        # a root here so ingest requests produce full Chrome-trace
        # chains.  One flag check when tracing is off.
        rt = _trace.current()
        minted = rt is None and _trace.tracing()
        if minted:
            rt = _trace.start_request("serving.ingest.request")
        opcode = _OPS.get(op)
        expects(opcode is not None,
                f"ingest: op must be 'upsert' or 'delete', got {op!r}")
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        expects(ids.size > 0, "ingest: write needs at least one id")
        expects(int(ids.min()) >= 0, "ingest: source ids must be >= 0")
        if opcode == _delta.OP_UPSERT:
            vecs = np.ascontiguousarray(vectors, np.float32)
            if vecs.ndim == 1:
                vecs = vecs[None, :]
            expects(vecs.shape == (ids.size, self.memtable.dim),
                    f"ingest: vectors must be ({ids.size}, "
                    f"{self.memtable.dim}), got {vecs.shape}")
        else:
            expects(vectors is None, "ingest: delete takes no vectors")
            vecs = None
        if rt is not None:
            rt.annotate("tenant", tenant)
            rt.annotate("op", op)
            rt.annotate("rows", int(ids.size))
        try:
            self._admit(int(ids.size), tenant, opcode)
        except Overloaded:
            if minted:
                # shed at the door: the trace still lands in the flight
                # recorder, same contract as a shed read submit
                rt.annotate("shed", True)
                _flight.record_trace(rt.close())
            raise
        with self._lock:
            lsn = self._lsn + 1
            t_append = _trace.now() if rt is not None else 0.0
            self._wal.append(encode_record(lsn, opcode, ids, vecs))
            self._lsn = lsn
            self._replay_debt_rows += int(ids.size)
            if self._oldest_pending_ts is None:
                self._oldest_pending_ts = t0
            _count("serving.ingest.appended")
            # apply inside the append lock: memtable order == WAL order,
            # so replay reproduces the live state record for record.
            # Rows are searchable HERE — before the fsync — so
            # visibility is decoupled from durability; the ack below
            # still waits for the fsync.
            faults.maybe_fail("ingest.apply")
            if rt is not None:
                t_apply = _trace.now()
                rt.span("serving.ingest.append", t_append, t_apply,
                        lsn=lsn, rows=int(ids.size))
            self.memtable.apply(_delta.Record(lsn=lsn, op=opcode, ids=ids,
                                              vectors=vecs))
            if rt is not None:
                rt.span("serving.ingest.apply", t_apply, _trace.now())
            if obs.enabled():
                obs.registry().histogram(
                    "serving.ingest.visibility").observe(self._clock() - t0)
        t_sync = _trace.now() if rt is not None else 0.0
        self._sync_upto(lsn)
        _count("serving.ingest.acked")
        _gauge("serving.ingest.wal_bytes", self._wal.size_bytes)
        _gauge("serving.ingest.memtable_rows", self.memtable.live_rows)
        if rt is not None:
            rt.span("serving.ingest.fsync", t_sync, _trace.now(), lsn=lsn)
            rt.annotate("lsn", lsn)
            if minted:
                _flight.record_trace(rt.close())
        return lsn

    def _sync_upto(self, lsn: int) -> None:
        """Group commit: wait until the WAL is durable through ``lsn``.
        The first waiter performs ONE fsync covering every record
        appended so far; concurrent writers ride it.

        A failed fsync fails the ack of the WHOLE group: the performer
        re-raises, and every rider whose record was in flight during
        the failed epoch re-raises the same error instead of silently
        riding a later, luckier fsync — their rows were applied
        (visible) but never proven durable, so acking them would break
        the durability contract.  The WAL tail is left exactly as
        appended: any torn suffix is the repairable-tail case
        :func:`scan_wal` already handles, so the next :meth:`recover`
        repairs and replays cleanly.  Writers arriving AFTER the
        failure start a fresh epoch and may ack on a new fsync."""
        with self._sync_cond:
            if self._synced_lsn >= lsn:
                return
            epoch = self._sync_epoch
        while True:
            with self._sync_cond:
                if self._synced_lsn >= lsn:
                    return
                if self._sync_epoch != epoch:
                    # a group fsync covering our in-flight record
                    # failed: this ack fails with the group
                    raise self._sync_exc
                if self._sync_busy:
                    self._sync_cond.wait(timeout=1.0)
                    continue
                self._sync_busy = True
            try:
                with self._lock:
                    target = self._lsn
                self._wal.sync()
            except BaseException as exc:
                with self._sync_cond:
                    self._sync_busy = False
                    self._sync_epoch += 1
                    self._sync_exc = exc
                    self._sync_cond.notify_all()
                raise
            with self._sync_cond:
                self._synced_lsn = max(self._synced_lsn, target)
                self._sync_busy = False
                self._sync_cond.notify_all()

    # ---- admission -------------------------------------------------------

    def _admit(self, n_rows: int, tenant: str, opcode: int) -> None:
        bo = self._brownout
        if (bo is not None
                and getattr(bo, "shed_best_effort_writes", False)
                and tenant in bo.best_effort_tenants):
            _count("serving.ingest.shed.brownout")
            _flight.record_event("serving.ingest.shed.brownout",
                                 tenant=tenant, rows=n_rows,
                                 level=bo.level)
            raise BrownedOut(
                f"ingest: best-effort tenant {tenant!r} writes shed at "
                f"brownout level {bo.level} — retry with backoff")
        bucket = self._buckets.get(tenant)
        if bucket is not None and not bucket.try_acquire(n_rows):
            _count("serving.ingest.shed.quota")
            _flight.record_event("serving.ingest.shed.quota",
                                 tenant=tenant, rows=n_rows,
                                 rate=bucket.rate, burst=bucket.burst)
            raise QuotaExceeded(
                f"ingest: tenant {tenant!r} exceeded its write quota "
                f"({bucket.rate:g} rows/s, burst {bucket.burst:g})")
        rows = self.memtable.live_rows
        wal_bytes = self._wal.size_bytes if self._wal is not None else 0
        # the rows bound gates UPSERTS only: deletes drain live rows, so
        # shedding them under row pressure would wedge the very writes
        # that relieve it (they still respect the WAL-lag bound)
        over_rows = (opcode == _delta.OP_UPSERT
                     and rows + n_rows > self.config.max_memtable_rows)
        over_wal = wal_bytes >= self.config.max_wal_bytes
        if over_rows or over_wal:
            _count("serving.ingest.shed.backpressure")
            if not self._backpressured:
                self._backpressured = True
                _flight.record_event("serving.ingest.backpressure",
                                     state="enter", memtable_rows=rows,
                                     wal_bytes=wal_bytes, rows=n_rows)
            raise Overloaded(
                f"ingest: write backpressure (memtable {rows} rows"
                f"{' > bound' if over_rows else ''}, WAL {wal_bytes} bytes"
                f"{' > bound' if over_wal else ''}) — retry after the "
                f"next fold")
        if self._backpressured:
            self._backpressured = False
            _flight.record_event("serving.ingest.backpressure",
                                 state="exit", memtable_rows=rows,
                                 wal_bytes=wal_bytes)

    # ---- fold ------------------------------------------------------------

    def maybe_fold(self):
        """Fold when a configured trigger fires (the rebalancer's
        per-pass hook); returns the new index or None.

        Two trigger families: the size thresholds (``fold_rows`` /
        ``fold_tombstones``) and the WAL-lag / visibility targets — ``fold_replay_debt_rows`` fires when the rows a
        recovery would have to replay exceed the bound, and
        ``fold_visibility_lag_s`` fires when the oldest unfolded record
        has been pinned in the delta tier past the target.  Each
        lag-family firing ticks its own counter
        (``serving.ingest.fold_trigger.rows`` /
        ``serving.ingest.fold_trigger.lag``) so the fold cadence is
        attributable to a cause, not just observed."""
        rows, tombs = self.memtable.live_rows, self.memtable.n_tombstones
        cfg = self.config
        trigger = None
        if ((cfg.fold_rows and rows >= cfg.fold_rows)
                or (cfg.fold_tombstones
                    and tombs >= cfg.fold_tombstones)):
            trigger = "threshold"
        elif (cfg.fold_replay_debt_rows
                and self._replay_debt_rows >= cfg.fold_replay_debt_rows):
            trigger = "rows"
            _count("serving.ingest.fold_trigger.rows")
        elif (cfg.fold_visibility_lag_s
                and self._oldest_pending_ts is not None
                and (self._clock() - self._oldest_pending_ts
                     >= cfg.fold_visibility_lag_s)):
            trigger = "lag"
            _count("serving.ingest.fold_trigger.lag")
        if trigger is None:
            return None
        return self.fold()

    def fold(self):
        """Fold the memtable into the main index: one checkpointed,
        gated compaction (see the module docstring for the crash-window
        analysis).  Writes block for the duration; searches keep serving
        the pre-fold view until the swap publishes.  Returns the new
        index, or None when the delta tier is empty."""
        with self._fold_lock, self._lock:
            mem = self.memtable
            if mem.live_rows == 0 and mem.n_tombstones == 0:
                return None
            base = self._current_index()
            expects(base is not None,
                    "ingest: fold needs a bound server or a recovered "
                    "base index")
            faults.maybe_fail("ingest.fold")
            # fold trace: adopt the ambient recorder when one is active
            # (a traced caller), else mint a root — the stage() below
            # mirrors its timer onto whichever is current, so the
            # Chrome-trace chain shows the fold span either way
            frt = None
            if _trace.current() is None and _trace.tracing():
                frt = _trace.start_request("serving.ingest.request")
                frt.annotate("op", "fold")
            with _trace.activating(frt), obs.stage("serving.ingest.fold"):
                fold_lsn = self._lsn
                live_ids, live_rows, tomb_ids = mem.fold_payload()
                mod = (ivf_flat if isinstance(base, ivf_flat.Index)
                       else ivf_pq)
                parent_gen = _mutate.generation(base)
                # upsert semantics: clear EVERY touched id (deletes and
                # overwrites), then extend the live rows back — exactly
                # the module-level upsert pattern, ONE public bump
                clear = np.union1d(tomb_ids, live_ids).astype(np.int32)
                cand = base
                if clear.size:
                    cand = mod.delete(self.res, cand,
                                      torch.from_numpy(clear))
                if live_ids.size:
                    cand = mod.extend(self.res, cand,
                                      torch.from_numpy(live_rows),
                                      torch.from_numpy(live_ids))
                cand.generation = parent_gen + 1
                # the gate: no fold candidate is published unverified
                _verify_index(cand, self.config.verify_level, res=self.res,
                              n_rows=_id_span(cand))
                if getattr(cand, "canaries", None) is not None:
                    _canary.health_check(self.res, cand, raise_on_fail=True)
                # durable commit marker BEFORE the swap: a kill after
                # this point rolls FORWARD (recover publishes the
                # candidate and finishes the truncation)
                self._save_fold(cand, mod, fold_lsn)
                self._publish(cand)
                # truncate only after the gated swap landed
                self._wal.truncate_all()
                mem.reset()
                with self._sync_cond:
                    self._synced_lsn = self._lsn
                self._replay_debt_rows = 0
                self._oldest_pending_ts = None
                self._ck.clear()
                _count("serving.ingest.folds")
                _flight.record_event("serving.ingest.fold",
                                     rows=int(live_ids.size),
                                     tombstones=int(tomb_ids.size),
                                     fold_lsn=fold_lsn,
                                     generation=_mutate.generation(cand))
            if frt is not None:
                frt.annotate("rows", int(live_ids.size))
                frt.annotate("tombstones", int(tomb_ids.size))
                frt.annotate("generation", _mutate.generation(cand))
                _flight.record_trace(frt.close())
            return cand

    def _save_fold(self, cand, mod, fold_lsn: int) -> None:
        buf = io.BytesIO()
        mod.serialize(self.res, buf, cand)
        self._ck.save(_FOLD_STAGE, {
            "index": np.frombuffer(buf.getvalue(), np.uint8),
            "kind": np.frombuffer(
                ("ivf_flat" if mod is ivf_flat else "ivf_pq").encode(),
                np.uint8),
            "generation": np.asarray([_mutate.generation(cand)], np.int64),
            "fold_lsn": np.asarray([fold_lsn], np.int64)})

    def _load_fold(self):
        arrays = self._ck.load(_FOLD_STAGE)
        kind = bytes(arrays["kind"]).decode()
        mod = ivf_flat if kind == "ivf_flat" else ivf_pq
        idx = mod.deserialize(self.res, io.BytesIO(bytes(arrays["index"])))
        idx.generation = int(arrays["generation"][0])
        return idx, int(arrays["fold_lsn"][0])

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def __enter__(self) -> "IngestServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, object]:
        return {
            "last_lsn": self._lsn,
            "synced_lsn": self._synced_lsn,
            "wal_bytes": self._wal.size_bytes if self._wal else 0,
            "memtable_rows": self.memtable.live_rows,
            "tombstones": self.memtable.n_tombstones,
            "memtable_capacity": self.memtable.capacity,
            "backpressured": self._backpressured,
            "replay_debt_rows": self._replay_debt_rows,
        }


def _id_span(index) -> int:
    """Max decoded source id + 1 — the verify bound for a folded
    snapshot, whose live id space is sparse (same convention as the
    rebalancer's gate)."""
    li = index.list_indices.cpu().numpy()
    dec = np.where(li <= -2, -li.astype(np.int64) - 2, li.astype(np.int64))
    vals = dec[(li >= 0) | (li <= -2)]
    return int(vals.max()) + 1 if vals.size else 0
