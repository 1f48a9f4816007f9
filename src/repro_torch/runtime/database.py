"""Durable, validated, run-key-addressed result store (paper §V.B/§V.C).

The database replaces input/output files: it stores every *block average*
(never running averages — those are recomputed on demand by queries), the
walker reservoir for restarts, and is keyed by a CRC-32 of the run's
critical data so results from different simulations can never mix.

Properties inherited from this design (paper's list):
  * checkpoint/restart is always available (the DB is the checkpoint);
  * post-hoc analysis (correlations, re-weighting) on stored blocks;
  * merging grid results  = merging databases (`merge_from`);
  * many independent jobs may write to the same database concurrently
    (sqlite WAL mode + busy retry) to gather elastic resources.

The multi-tenant service layer (``repro.serve``) hardens this store into a
long-lived shared artifact, following vulcanDB's load / validator /
benchmarking split:

* **Schema versioning** — a ``meta`` table stamps ``SCHEMA_VERSION``;
  opening a file written by a *newer* schema refuses (no silent
  misreads), while a legacy v1 file (pre-``meta``) is migrated in place.
* **Ingest validation** — ``validate_block`` is the single gate every
  block passes on ``append``: malformed identity, non-positive or
  non-finite statistics, a negative implied variance, or non-finite aux
  entries are *rejected and counted* (``rejects``), never stored.  With
  ``require_registered=True`` (the service's mode) a block whose
  ``run_key`` has no row in the ``runs`` registry — the foreign-key check
  — is rejected too.
* **Run registry + quotas** — ``register_run`` records the declarative
  spec payload under its run key (what ``extend``/``fork`` rebuild from);
  ``set_quota`` bounds how many blocks a key may accumulate (multi-tenant
  fairness: one runaway run cannot fill the store).
* **Compaction** — ``compact`` folds a key's block rows (and any earlier
  segments) into one *running-average segment* holding the exact
  sufficient statistics (Σw, Σw·e, Σw·e², Σw·e_mean², n); the
  ``running_average`` a query returns is bitwise identical before and
  after compaction because both paths accumulate the same sums in the
  same deterministic order.  Per-worker block-id watermarks preserve the
  replay-dedupe contract for rows whose PK was compacted away.
* **Cross-run accumulation** — ``accumulate`` combines several run keys
  (a fork family) into one average; ``run_keys``/``run_summary`` are the
  store's catalogue queries.

Durability: WAL journaling makes each committed ``append`` transaction
crash-safe — a SIGKILL mid-append loses at most the uncommitted
transaction, never tears a row (tests kill -9 a writer and revalidate).
"""
from __future__ import annotations

import collections
import hashlib
import io
import json
import math
import sqlite3
import threading
import zlib
from typing import Iterable

import numpy as np

from repro_torch.runtime.blocks import BlockResult, RunningAverage

SCHEMA_VERSION = 2

# ingest-reject reasons (validator verdicts; counted per reason)
R_KEY = 'bad_run_key'
R_IDENTITY = 'bad_identity'
R_WEIGHT = 'bad_weight'
R_ENERGY = 'non_finite_energy'
R_VARIANCE = 'negative_variance'
R_AUX = 'bad_aux'
R_UNREGISTERED = 'unregistered_run_key'
R_QUOTA = 'quota_exceeded'

_MAX_KEY_LEN = 256


def critical_data_key(**critical) -> str:
    """CRC-32 hex over the run's critical data (paper §V.C).

    Critical data = anything that changes the *estimator* (geometry, MOs,
    Jastrow parameters, time step...).  Walker counts / block lengths are
    explicitly NOT critical (results remain combinable across them).
    """
    crc = 0
    for name in sorted(critical):
        v = critical[name]
        crc = zlib.crc32(name.encode(), crc)
        if isinstance(v, np.ndarray):
            crc = zlib.crc32(np.ascontiguousarray(v).tobytes(), crc)
        else:
            crc = zlib.crc32(json.dumps(v, sort_keys=True,
                                        default=float).encode(), crc)
    return f'{crc & 0xffffffff:08x}'


def validate_block(b: BlockResult, schema_version: int = SCHEMA_VERSION
                   ) -> str | None:
    """Validate one block for ingest; returns a reject reason or ``None``.

    The v1 rules are the historical ``BlockResult.is_valid`` (positive
    weight, finite energies); v2 adds identity checks, the implied-variance
    bound (``e2_mean >= e_mean**2`` up to fp tolerance — a violation means
    the sufficient statistics cannot have come from one sample set), and
    finite scalar aux entries.  Registration (foreign-key) and quota checks
    are store state, so they live in ``ResultDatabase.append``.
    """
    if not (b.weight > 0.0 and math.isfinite(b.weight)
            and math.isfinite(b.e_mean) and math.isfinite(b.e2_mean)):
        return R_WEIGHT if not (b.weight > 0.0 and math.isfinite(b.weight)) \
            else R_ENERGY
    if schema_version < 2:
        return None
    if (not isinstance(b.run_key, str) or not b.run_key
            or len(b.run_key) > _MAX_KEY_LEN or not b.run_key.isprintable()):
        return R_KEY
    try:
        wid, bid = int(b.worker_id), int(b.block_id)
    except (TypeError, ValueError):
        return R_IDENTITY
    if wid < 0 or bid < 0 or not isinstance(b.job, str):
        return R_IDENTITY
    # Jensen: the weighted mean of E^2 can never sit below the square of
    # the weighted mean of E (same samples, same weights) — allow only
    # floating-point slack from sub-block merging
    tol = 1e-9 * max(1.0, b.e_mean * b.e_mean)
    if b.e2_mean < b.e_mean * b.e_mean - tol:
        return R_VARIANCE
    for k, v in dict(b.aux).items():
        if not isinstance(k, str):
            return R_AUX
        try:
            if not math.isfinite(float(v)):
                return R_AUX
        except (TypeError, ValueError):
            return R_AUX
    if not math.isfinite(b.timestamp):
        return R_IDENTITY
    return None


class ResultDatabase:
    """Thread-safe sqlite store for blocks, segments, runs + reservoirs.

    ``require_registered=True`` turns on the foreign-key ingest check:
    blocks whose run key was never ``register_run``'d are rejected (the
    multi-tenant service's mode — nothing lands in the store without a
    registered owner).  The default (off) keeps the engine-level API
    (tests, embedding, single-run CLIs) friction-free.
    """

    def __init__(self, path: str = ':memory:',
                 require_registered: bool = False):
        self.path = path
        self.require_registered = bool(require_registered)
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=30.0)
        self._lock = threading.RLock()   # reentrant: compact holds it
        #                                  across its read-fold-write txn
        self.rejects: collections.Counter = collections.Counter()
        with self._lock:
            self._conn.execute('PRAGMA journal_mode=WAL')
            # concurrent multi-writer appends against one file: retry on
            # SQLITE_BUSY instead of erroring out of a worker thread
            self._conn.execute('PRAGMA busy_timeout=10000')
            self._migrate()

    def _migrate(self) -> None:
        """Create/upgrade the schema; refuse files from a newer schema."""
        c = self._conn
        c.execute('''CREATE TABLE IF NOT EXISTS blocks (
            run_key TEXT NOT NULL, job TEXT NOT NULL,
            worker_id INTEGER, block_id INTEGER,
            weight REAL, e_mean REAL, e2_mean REAL,
            aux TEXT, timestamp REAL,
            PRIMARY KEY (run_key, job, worker_id, block_id))''')
        c.execute('''CREATE TABLE IF NOT EXISTS reservoir (
            run_key TEXT PRIMARY KEY, payload BLOB, timestamp REAL)''')
        c.execute('''CREATE TABLE IF NOT EXISTS meta (
            key TEXT PRIMARY KEY, value TEXT)''')
        row = c.execute("SELECT value FROM meta WHERE key='schema_version'"
                        ).fetchone()
        found = int(row[0]) if row is not None else None
        if found is not None and found > SCHEMA_VERSION:
            c.close()
            raise RuntimeError(
                f'database {self.path!r} has schema v{found}; this build '
                f'reads up to v{SCHEMA_VERSION} — refusing to misread it')
        c.execute('''CREATE TABLE IF NOT EXISTS runs (
            run_key TEXT PRIMARY KEY, spec TEXT, quota_blocks INTEGER
            DEFAULT 0, created REAL)''')
        c.execute('''CREATE TABLE IF NOT EXISTS segments (
            run_key TEXT NOT NULL, seg_id INTEGER, seg_uid TEXT NOT NULL,
            n_blocks INTEGER, weight REAL, e_sum REAL, e2_sum REAL,
            ee_sum REAL, t_min REAL, t_max REAL,
            PRIMARY KEY (run_key, seg_id),
            UNIQUE (run_key, seg_uid))''')
        # every segment uid this store has ever absorbed — survives the
        # segment row itself being folded away by a later compaction, so
        # re-merging the same peer stays a no-op (idempotent union)
        c.execute('''CREATE TABLE IF NOT EXISTS seg_seen (
            run_key TEXT NOT NULL, seg_uid TEXT NOT NULL,
            PRIMARY KEY (run_key, seg_uid))''')
        c.execute('''CREATE TABLE IF NOT EXISTS watermarks (
            run_key TEXT NOT NULL, job TEXT NOT NULL, worker_id INTEGER,
            max_block_id INTEGER,
            PRIMARY KEY (run_key, job, worker_id))''')
        c.execute("INSERT OR REPLACE INTO meta VALUES ('schema_version', ?)",
                  (str(SCHEMA_VERSION),))
        c.commit()

    @property
    def schema_version(self) -> int:
        """The schema this store was opened at (stamped in ``meta``)."""
        return SCHEMA_VERSION

    # -- run registry (foreign keys, quotas, spec payloads) ----------------
    def register_run(self, run_key: str, spec: dict | None = None,
                     quota_blocks: int | None = None) -> None:
        """Record a run key (+ its declarative spec payload and quota).

        Idempotent; re-registering updates the spec payload but keeps an
        existing quota unless one is given (a resubmit must not silently
        reset the tenant's budget).
        """
        spec_json = json.dumps(spec, sort_keys=True) if spec is not None \
            else None
        with self._lock:
            row = self._conn.execute(
                'SELECT quota_blocks FROM runs WHERE run_key=?',
                (run_key,)).fetchone()
            quota = (int(quota_blocks) if quota_blocks is not None
                     else (int(row[0]) if row is not None else 0))
            self._conn.execute(
                'INSERT OR REPLACE INTO runs VALUES (?, ?, ?, '
                "COALESCE((SELECT created FROM runs WHERE run_key=?), "
                "strftime('%s','now')))",
                (run_key, spec_json, quota, run_key))
            self._conn.commit()

    def get_run_spec(self, run_key: str) -> dict | None:
        """The registered declarative spec payload for a key (or None)."""
        with self._lock:
            row = self._conn.execute(
                'SELECT spec FROM runs WHERE run_key=?', (run_key,)
            ).fetchone()
        if row is None or row[0] is None:
            return None
        return json.loads(row[0])

    def known_run(self, run_key: str) -> bool:
        """Whether the key is registered (the ingest foreign-key check)."""
        with self._lock:
            return self._conn.execute(
                'SELECT 1 FROM runs WHERE run_key=?', (run_key,)
            ).fetchone() is not None

    def set_quota(self, run_key: str, max_blocks: int) -> None:
        """Bound how many blocks a key may hold (0 = unlimited)."""
        with self._lock:
            self._conn.execute(
                'INSERT INTO runs (run_key, spec, quota_blocks, created) '
                "VALUES (?, NULL, ?, strftime('%s','now')) "
                'ON CONFLICT(run_key) DO UPDATE SET quota_blocks=?',
                (run_key, int(max_blocks), int(max_blocks)))
            self._conn.commit()

    def run_keys(self) -> list[str]:
        """Every run key present in blocks, segments, or the registry."""
        with self._lock:
            rows = self._conn.execute(
                'SELECT run_key FROM runs UNION '
                'SELECT DISTINCT run_key FROM blocks UNION '
                'SELECT DISTINCT run_key FROM segments').fetchall()
        return sorted(r[0] for r in rows)

    # -- blocks -----------------------------------------------------------
    def append(self, blocks: Iterable[BlockResult]) -> int:
        """Validated, quota-checked, deduped ingest; returns rows added.

        Every block passes ``validate_block``; a rejected block is counted
        in ``self.rejects`` by reason and never stored.  A block at or
        below its ``(run_key, job, worker_id)`` compaction watermark is a
        replay of a row already folded into a segment — silently deduped,
        exactly like the primary-key ``INSERT OR IGNORE``.
        """
        blocks = list(blocks)
        accepted: list[BlockResult] = []
        quota_cache: dict[str, int | None] = {}
        for b in blocks:
            reason = validate_block(b)
            if reason is None and self.require_registered \
                    and not self.known_run(b.run_key):
                reason = R_UNREGISTERED
            if reason is None:
                quota = quota_cache.get(b.run_key, -1)
                if quota == -1:
                    quota = self._quota(b.run_key)
                    quota_cache[b.run_key] = quota
                if quota and self.n_blocks(b.run_key) + sum(
                        a.run_key == b.run_key for a in accepted) >= quota:
                    reason = R_QUOTA
            if reason is not None:
                self.rejects[reason] += 1
                continue
            accepted.append(b)
        if not accepted:
            return 0
        rows = [(b.run_key, b.job, b.worker_id, b.block_id, b.weight,
                 b.e_mean, b.e2_mean, json.dumps(dict(b.aux)), b.timestamp)
                for b in accepted]
        with self._lock:
            cur = self._conn.executemany(
                'INSERT OR IGNORE INTO blocks '
                'SELECT ?,?,?,?,?,?,?,?,? WHERE NOT EXISTS ('
                '  SELECT 1 FROM watermarks w WHERE w.run_key=?1 '
                '  AND w.job=?2 AND w.worker_id=?3 AND w.max_block_id>=?4)',
                rows)
            self._conn.commit()
        return cur.rowcount if cur.rowcount >= 0 else len(rows)

    def _quota(self, run_key: str) -> int:
        with self._lock:
            row = self._conn.execute(
                'SELECT quota_blocks FROM runs WHERE run_key=?',
                (run_key,)).fetchone()
        return int(row[0]) if row is not None and row[0] else 0

    def blocks(self, run_key: str) -> list[BlockResult]:
        """Stored (non-compacted) block rows, in deterministic PK order."""
        with self._lock:
            rows = self._conn.execute(
                'SELECT run_key, job, worker_id, block_id, weight, e_mean, '
                'e2_mean, aux, timestamp FROM blocks WHERE run_key=? '
                'ORDER BY job, worker_id, block_id',
                (run_key,)).fetchall()
        return [BlockResult(r[0], r[2], r[3], r[4], r[5], r[6],
                            json.loads(r[7]), r[8], job=r[1]) for r in rows]

    @staticmethod
    def _segment_uid(n: int, w_sum: float, e_sum: float, e2_sum: float,
                     ee_sum: float, t_lo: float, t_hi: float) -> str:
        """Content identity of a segment: exact bytes of its statistics.

        Two segments with bitwise-identical sufficient statistics and time
        span are the same fold of the same blocks — which is what makes a
        repeated ``merge_from`` of a compacted peer a no-op.
        """
        raw = ':'.join([str(int(n))] + [float(x).hex() for x in
                                        (w_sum, e_sum, e2_sum, ee_sum,
                                         t_lo, t_hi)])
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def _sums(self, run_keys: Iterable[str]
              ) -> tuple[int, float, float, float, float]:
        """Exact sufficient statistics over segments + loose blocks.

        Deterministic accumulation order — segments (by key, seg_id) first,
        then blocks (by key, PK order) — so re-running the query, reopening
        the file, or compacting (which folds *in this same order*) all
        reproduce bitwise-identical sums.
        """
        n, w_sum, e_sum, e2_sum, ee_sum = 0, 0.0, 0.0, 0.0, 0.0
        for key in run_keys:
            with self._lock:
                segs = self._conn.execute(
                    'SELECT n_blocks, weight, e_sum, e2_sum, ee_sum '
                    'FROM segments WHERE run_key=? ORDER BY seg_id',
                    (key,)).fetchall()
                rows = self._conn.execute(
                    'SELECT weight, e_mean, e2_mean FROM blocks '
                    'WHERE run_key=? ORDER BY job, worker_id, block_id',
                    (key,)).fetchall()
            for nb, w, es, e2s, ees in segs:
                n += int(nb)
                w_sum += w
                e_sum += es
                e2_sum += e2s
                ee_sum += ees
            for w, e, e2 in rows:
                n += 1
                w_sum += w
                e_sum += w * e
                e2_sum += w * e2
                ee_sum += w * e * e
        return n, w_sum, e_sum, e2_sum, ee_sum

    @staticmethod
    def _average(n: int, w_sum: float, e_sum: float, e2_sum: float,
                 ee_sum: float) -> RunningAverage:
        if n == 0 or w_sum <= 0.0:
            return RunningAverage(0, 0.0, float('nan'), float('nan'),
                                  float('inf'))
        e = e_sum / w_sum
        var = max(e2_sum / w_sum - e * e, 0.0)
        if n > 1:
            # weighted spread of block means around the global mean:
            # sum w_b (e_b - E)^2 = ee_sum - W E^2  (since sum w_b e_b = WE)
            num = max(ee_sum - w_sum * e * e, 0.0)
            err = math.sqrt(num / w_sum / (n - 1))
        else:
            err = float('inf')
        return RunningAverage(n, w_sum, e, var, err)

    def running_average(self, run_key: str) -> RunningAverage:
        """The paper's 'post-processed on demand by database queries'.

        Computed from exact sufficient statistics over segments + blocks,
        so the value is bitwise reproducible across reopen, restart, and
        compaction — which is what lets ``extend`` continue a stored
        average from exactly where it stopped.
        """
        return self._average(*self._sums([run_key]))

    def accumulate(self, run_keys: Iterable[str]) -> RunningAverage:
        """Cross-run accumulation: one average over several run keys.

        The multi-tenant query for fork families / grid mergers — same
        weighted combination rule, several keys' statistics pooled."""
        return self._average(*self._sums(list(run_keys)))

    def n_blocks(self, run_key: str) -> int:
        """Total blocks under the key, compacted segments included."""
        with self._lock:
            (n,) = self._conn.execute(
                'SELECT COUNT(*) FROM blocks WHERE run_key=?',
                (run_key,)).fetchone()
            row = self._conn.execute(
                'SELECT COALESCE(SUM(n_blocks), 0) FROM segments '
                'WHERE run_key=?', (run_key,)).fetchone()
        return int(n) + int(row[0])

    def run_summary(self) -> list[dict]:
        """Catalogue query: per-key block counts + current averages."""
        out = []
        for key in self.run_keys():
            avg = self.running_average(key)
            out.append(dict(run_key=key, n_blocks=avg.n_blocks,
                            weight=avg.weight, energy=avg.energy,
                            error=avg.error, registered=self.known_run(key),
                            quota=self._quota(key)))
        return out

    # -- compaction --------------------------------------------------------
    def compact(self, run_key: str) -> int:
        """Fold a key's block rows (+ prior segments) into one segment.

        Stores the exact sufficient statistics accumulated in query order,
        so ``running_average`` is bitwise identical before and after; the
        per-worker block-id watermarks keep replay dedupe working for the
        rows whose primary keys were just deleted.  Returns the number of
        block rows compacted away.
        """
        with self._lock:
            # the whole read-fold-write runs inside one IMMEDIATE
            # transaction: a concurrent appender (same process: the RLock;
            # other processes: the sqlite write lock) can never slip a
            # block between the fold and the delete
            self._conn.execute('BEGIN IMMEDIATE')
            n, w_sum, e_sum, e2_sum, ee_sum = self._sums([run_key])
            if n == 0:
                self._conn.execute('ROLLBACK')
                return 0
            ts = self._conn.execute(
                'SELECT MIN(timestamp), MAX(timestamp) FROM blocks '
                'WHERE run_key=?', (run_key,)).fetchone()
            seg_ts = self._conn.execute(
                'SELECT MIN(t_min), MAX(t_max) FROM segments WHERE '
                'run_key=?', (run_key,)).fetchone()
            t_lo = min(x for x in (ts[0], seg_ts[0]) if x is not None) \
                if (ts[0] is not None or seg_ts[0] is not None) else 0.0
            t_hi = max(x for x in (ts[1], seg_ts[1]) if x is not None) \
                if (ts[1] is not None or seg_ts[1] is not None) else 0.0
            # watermarks: remember the highest folded block id per writer
            self._conn.execute(
                'INSERT INTO watermarks '
                'SELECT run_key, job, worker_id, MAX(block_id) FROM blocks '
                'WHERE run_key=? GROUP BY job, worker_id '
                'ON CONFLICT(run_key, job, worker_id) DO UPDATE SET '
                'max_block_id=MAX(max_block_id, excluded.max_block_id)',
                (run_key,))
            (n_rows,) = self._conn.execute(
                'SELECT COUNT(*) FROM blocks WHERE run_key=?',
                (run_key,)).fetchone()
            self._conn.execute('DELETE FROM blocks WHERE run_key=?',
                               (run_key,))
            self._conn.execute('DELETE FROM segments WHERE run_key=?',
                               (run_key,))
            uid = self._segment_uid(n, w_sum, e_sum, e2_sum, ee_sum,
                                    t_lo, t_hi)
            self._conn.execute(
                'INSERT INTO segments VALUES (?, 0, ?, ?, ?, ?, ?, ?, ?, ?)',
                (run_key, uid, n, w_sum, e_sum, e2_sum, ee_sum, t_lo, t_hi))
            self._conn.execute(
                'INSERT OR IGNORE INTO seg_seen VALUES (?, ?)',
                (run_key, uid))
            self._conn.commit()
        return int(n_rows)

    # -- validation sweep (vulcanDB's standalone validator pass) -----------
    def validate_all(self, run_key: str | None = None) -> dict:
        """Re-validate every stored row; the post-crash integrity sweep.

        Returns ``{'checked': n, 'rejects': {reason: count}, 'clean':
        bool}``.  A store that only ever ingested through ``append`` and
        survived a crash cleanly reports zero rejects — the acceptance
        check after a kill -9 + reopen.
        """
        keys = [run_key] if run_key is not None else self.run_keys()
        checked = 0
        rejects: collections.Counter = collections.Counter()
        for key in keys:
            for b in self.blocks(key):
                checked += 1
                reason = validate_block(b)
                if reason is not None:
                    rejects[reason] += 1
            with self._lock:
                segs = self._conn.execute(
                    'SELECT n_blocks, weight, e_sum, e2_sum, ee_sum FROM '
                    'segments WHERE run_key=?', (key,)).fetchall()
            for nb, w, es, e2s, ees in segs:
                checked += 1
                if not (nb > 0 and w > 0 and all(map(math.isfinite,
                                                     (w, es, e2s, ees)))):
                    rejects[R_WEIGHT] += 1
        return dict(checked=checked, rejects=dict(rejects),
                    clean=not rejects)

    # -- walker reservoir (checkpoint) -------------------------------------
    def save_reservoir(self, run_key: str, walkers: np.ndarray,
                       energies: np.ndarray) -> None:
        """Checkpoint the stratified walker reservoir under the run key."""
        buf = io.BytesIO()
        np.savez_compressed(buf, walkers=walkers, energies=energies)
        with self._lock:
            self._conn.execute(
                'INSERT OR REPLACE INTO reservoir VALUES (?, ?, '
                "strftime('%s','now'))", (run_key, buf.getvalue()))
            self._conn.commit()

    def load_reservoir(self, run_key: str):
        """Stored (walkers, energies) for the key, or None."""
        with self._lock:
            row = self._conn.execute(
                'SELECT payload FROM reservoir WHERE run_key=?',
                (run_key,)).fetchone()
        if row is None:
            return None
        data = np.load(io.BytesIO(row[0]))
        return data['walkers'], data['energies']

    # -- grid merging -------------------------------------------------------
    def _total_blocks(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                'SELECT COUNT(*) FROM blocks').fetchone()
            (s,) = self._conn.execute(
                'SELECT COALESCE(SUM(n_blocks), 0) FROM segments'
            ).fetchone()
        return int(n) + int(s)

    def merge_from(self, other: 'ResultDatabase') -> int:
        """Union of two databases (paper: combining clusters = merging DBs).

        Idempotent at every granularity: loose blocks dedupe on the
        ``(run_key, job, worker_id, block_id)`` primary key, a peer's
        compacted segments dedupe on their content uid (recorded in
        ``seg_seen`` even after a later local compaction folds them), and
        the peer's watermarks are absorbed first — any local loose row a
        peer has already folded into a segment is dropped rather than
        double-counted.  Returns the net change in stored block count.
        """
        before = self._total_blocks()
        with other._lock:
            keys = [k for (k,) in other._conn.execute(
                'SELECT DISTINCT run_key FROM blocks').fetchall()]
            segs = other._conn.execute(
                'SELECT run_key, seg_uid, n_blocks, weight, e_sum, e2_sum, '
                'ee_sum, t_min, t_max FROM segments ORDER BY run_key, seg_id'
            ).fetchall()
            marks = other._conn.execute(
                'SELECT run_key, job, worker_id, max_block_id '
                'FROM watermarks').fetchall()
        with self._lock:
            # watermarks first: a peer's compacted blocks are already in
            # its segments, so any copy of them here — an existing local
            # loose row or a later replay — would double count once the
            # segment lands; the merged watermark covers both
            for key, job, wid, top in marks:
                self._conn.execute(
                    'INSERT INTO watermarks VALUES (?,?,?,?) '
                    'ON CONFLICT(run_key, job, worker_id) DO UPDATE SET '
                    'max_block_id=MAX(max_block_id, excluded.max_block_id)',
                    (key, job, wid, top))
                self._conn.execute(
                    'DELETE FROM blocks WHERE run_key=? AND job=? AND '
                    'worker_id=? AND block_id<=?', (key, job, wid, top))
            if marks:
                self._conn.commit()
        for k in keys:
            self.append(other.blocks(k))
        with self._lock:
            for key, uid, nb, w, es, e2s, ees, t0, t1 in segs:
                seen = self._conn.execute(
                    'SELECT 1 FROM seg_seen WHERE run_key=? AND seg_uid=?',
                    (key, uid)).fetchone()
                if seen is not None:
                    continue                     # already absorbed once
                (top,) = self._conn.execute(
                    'SELECT COALESCE(MAX(seg_id), -1) FROM segments '
                    'WHERE run_key=?', (key,)).fetchone()
                self._conn.execute(
                    'INSERT INTO segments VALUES (?,?,?,?,?,?,?,?,?,?)',
                    (key, top + 1, uid, nb, w, es, e2s, ees, t0, t1))
                self._conn.execute(
                    'INSERT OR IGNORE INTO seg_seen VALUES (?, ?)',
                    (key, uid))
            if segs:
                self._conn.commit()
        return self._total_blocks() - before

    def close(self):
        """Close the underlying sqlite connection."""
        with self._lock:
            self._conn.close()
