"""Lookahead prefetch pipeline and eviction writeback manager.

Equivalent of the reference's Prefetcher/eviction processes
(/root/reference/cache_manager.py). The reference shards the lookahead window
across a ``mp.Pool`` because torch ops hold the GIL; our hot host ops
(np.unique, master-row fancy-gather) release the GIL, so the default backend
is a thread pool parallelizing across *tables* — same work partition, no
pickling/shared-memory overhead. Queues are bounded ``queue.Queue``s: the
``put`` blocks when the trainer falls behind, reproducing the reference's
Manager-queue backpressure (main_no_ddp.py:624-625).

Pipeline protocol (one FIFO entry per lookahead window):
  WindowData(uniques[t], rows[t]) — per-table sorted unique indices of the
  next ``lookahead`` global batches and their master-table rows, i.e. exactly
  the reference's (cached_entries, uniques, maps) triple with the inverse map
  replaced by positional alignment (rows[t][i] belongs to uniques[t][i]).

Eviction writeback: a dedicated thread drains (tables, idxs, rows) tuples and
writes them into the master tables, overwrite or average
(cache_manager.py:48-64), exiting after ``timeout`` seconds of silence or on
the shutdown sentinel.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from cdlrm_tpu.cache.master import MasterTables
from cdlrm_tpu.ops import native
from cdlrm_tpu.utils import affinity

_SENTINEL = None


def _stream_iter(stream_fn, skip, epoch):
    """Call the stream with the epoch when its signature takes one
    (trainer._cache_stream does; plain test streams take only skip)."""
    try:
        return stream_fn(skip=skip, epoch=epoch)
    except TypeError:
        return stream_fn(skip=skip)

# per-window lookup-sample cap for the hot-set frequency estimate
# (WindowData.hot_slots): selection quality degrades gracefully, correctness
# never depends on it
HOT_SAMPLE_CAP = 1 << 22

# ---- process-backend worker state (reference uses a torch mp.Pool over
# shared-memory tables, cache_manager.py:77-100; here worker processes mmap
# the same table files, sharing pages through the OS cache) ----
_WORKER_TABLES: List[np.ndarray] = []


def _worker_pin(counter, base: int) -> None:
    _worker_pin_impl(counter, base)


def _process_worker_init(table_paths: List[str], pin=None) -> None:
    global _WORKER_TABLES
    _WORKER_TABLES = [np.load(p, mmap_mode="r") for p in table_paths]
    if pin is not None:
        _worker_pin(*pin)


def _process_worker_gather(t: int, idx_parts: List[np.ndarray]):
    idx = np.concatenate([p.reshape(-1) for p in idx_parts])
    uniq = np.unique(idx)
    return uniq, np.asarray(_WORKER_TABLES[t][uniq], dtype=np.float32)


@dataclass
class WindowData:
    uniques: List[np.ndarray]  # [T] arrays of sorted unique indices
    rows: List[np.ndarray]  # [T] arrays [U_t, D] of master rows
    num_batches: int  # batches covered by this window
    # shadow-planned refill (host_cache.InsertPlanSpec): the insert/evict
    # policy is a deterministic function of (occupancy, RNG, window uniques),
    # so the prefetcher's SHADOW controller computes each window's plan while
    # it streams — the trainer replays it (apply_plan_spec) instead of
    # planning on the refill critical path. None when the window's plan was
    # already applied before a checkpoint (mid-window resume; the trainer's
    # WINDOW_REPLAY path), or when no shadow is attached (unit tests).
    plan_spec: Optional[object] = None
    # post-refill probe statistics (host_cache.WindowStats), computed against
    # the shadow's POST-plan occupancy while the window is still in memory:
    # per-(replica, batch) worst miss/unique counts for the negotiated
    # staging buckets + window totals for the auto-dedup decision. Replaces
    # the trainer-side retained-batch / dataset-replay stats pass (one whole
    # extra data read per window at long-lookahead configs).
    stats: Optional[object] = None
    # data-stream position of the window's first batch (epoch, full-batch
    # index within it)
    start_epoch: int = 0
    start_j: int = 0
    # hot tier (StepConfig.hot_rows): the window's hottest POST-plan
    # resident cache rows, sorted ascending, selected from a deterministic
    # evenly-strided sample of the window's lookups (selection quality only
    # affects performance, never correctness — the cold bucket in stats is
    # exact for WHATEVER set is chosen). None when the hot tier is off.
    hot_slots: Optional[np.ndarray] = None


# canonical home is utils/affinity.py (the data loaders pin too); these
# aliases keep the pipeline-local names
_pin_current_thread = affinity.pin_current_thread
_worker_pin_impl = affinity.worker_pin


class EvictionManager(threading.Thread):
    """Writeback thread (reference Prefetcher.eviction_manager,
    cache_manager.py:48-64)."""

    def __init__(
        self,
        master: MasterTables,
        fifo: "queue.Queue",
        average_on_writeback: bool = False,
        timeout: float = 300.0,
        pin_core: Optional[int] = None,
        acc_store=None,
    ):
        super().__init__(daemon=True, name="eviction-manager")
        self.master = master
        self.fifo = fifo
        self.average = average_on_writeback
        self.timeout = timeout
        self.pin_core = pin_core
        # Config.adagrad_master_state: evicted ids' row-wise accumulators
        # ride the same fifo item and write back here (cache/master.py
        # AccumulatorStore) — always overwrite (state restore, not a merge)
        self.acc_store = acc_store
        self.rows_written = 0

    def run(self) -> None:
        if self.pin_core is not None:
            _pin_current_thread(self.pin_core)
        while True:
            try:
                item = self.fifo.get(timeout=self.timeout if self.timeout > 0 else None)
            except queue.Empty:
                return
            if item is _SENTINEL:
                return
            if isinstance(item, threading.Event):
                item.set()  # flush barrier: everything before it is durable
                continue
            # deferred device-fetch thunks resolve here, off the refill
            # critical path (the transfer can be 100s of MB per window)
            self._apply(item)

    def _apply(self, item) -> None:
        accs = None
        if len(item) == 4:
            tables, idxs, rows, accs = item
        else:
            tables, idxs, rows = item
        if callable(rows):
            rows = rows()
        if callable(accs):
            accs = accs()
        for t in np.unique(tables):
            sel = tables == t
            self.rows_written += self.master.writeback(
                int(t), idxs[sel], rows[sel], self.average
            )
            if accs is not None and self.acc_store is not None:
                self.acc_store.writeback(int(t), idxs[sel], accs[sel])

    def _drain_on_caller(self) -> None:
        try:
            while True:
                item = self.fifo.get_nowait()
                if item is _SENTINEL:
                    continue
                if isinstance(item, threading.Event):
                    item.set()
                    continue
                self._apply(item)
        except queue.Empty:
            pass

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every writeback enqueued so far has been applied
        (needed before checkpointing the master tables — in-flight evictions
        would otherwise be lost). If the manager thread already exited (idle
        timeout), the remaining queue is drained on the CALLING thread. The
        thread may also exit BETWEEN the liveness check and barrier
        consumption (idle timeout / sentinel race) — so a failed barrier wait
        re-checks liveness and falls back to caller-side draining instead of
        reporting a spurious failure."""
        if not self.is_alive():
            self._drain_on_caller()
            return True
        barrier = threading.Event()
        self.fifo.put(barrier)
        if barrier.wait(timeout):
            return True
        if not self.is_alive():
            self._drain_on_caller()
            return True
        return False


class LookaheadPrefetcher(threading.Thread):
    """Streams the upcoming index stream, dedups each lookahead window, and
    gathers the master rows (reference Prefetcher.run + process_batch_slice,
    cache_manager.py:28-46,66-115).

    ``cache_stream_fn`` returns a fresh iterator over per-batch sparse index
    arrays ([T, B] or [T, B, P] (+mask) — the dataset's *cache* stream,
    reference's cache_ld). Called once per epoch.
    """

    def __init__(
        self,
        cache_stream_fn: Callable[..., Iterator],
        master: MasterTables,
        lookahead: int,
        batch_fifo_size: int = 8,
        cache_workers: int = 2,
        nepochs: int = 1,
        pin_core: Optional[int] = None,
        worker_pin_base: Optional[int] = None,
        backend: str = "thread",
        start_epoch: int = 0,
        skip_batches: int = 0,
        shadow=None,
        stats_spec: Optional[tuple] = None,
        skip_first_plan: bool = False,
    ):
        """backend: 'thread' (default — numpy gathers release the GIL) or
        'process' (reference-style mp pool; requires mmap-backed MasterTables
        whose per-table .npy files the workers re-open read-only).

        (start_epoch, skip_batches): resume cursor — the first produced
        window starts at batch ``skip_batches`` of ``start_epoch`` (must be a
        window boundary: trainer passes floor(j/lookahead)*lookahead).
        ``cache_stream_fn`` must accept a ``skip`` kwarg; it MAY accept an
        ``epoch`` kwarg (passed when it does — the per-epoch shuffle
        protocol, data/criteo.py CriteoBinDataset).

        ``shadow``: a HostCacheController CLONE of the trainer's controller
        at pipeline start; this thread advances it one plan_insert_spec per
        window (WindowData.plan_spec) ahead of the trainer. ``stats_spec`` =
        (ndev, local_batch, want_uniq, hot_rows): also compute
        WindowData.stats against the post-plan shadow state (hot_rows > 0
        additionally selects WindowData.hot_slots and counts cold lookups
        against it). ``skip_first_plan``: the FIRST produced
        window's plan is already reflected in the shadow's start state
        (mid-window checkpoint resume) — emit plan_spec=None for it and only
        collect its stats."""
        super().__init__(daemon=True, name="lookahead-prefetcher")
        self.cache_stream_fn = cache_stream_fn
        self.master = master
        self.lookahead = max(1, lookahead)
        self.start_epoch = start_epoch
        self.skip_batches = skip_batches
        self.shadow = shadow
        self.stats_spec = stats_spec
        self.skip_first_plan = skip_first_plan
        self._windows_produced = 0
        self.fifo: "queue.Queue" = queue.Queue(maxsize=batch_fifo_size)
        self.cache_workers = max(1, cache_workers)
        self.nepochs = nepochs
        self.pin_core = pin_core
        self.worker_pin_base = worker_pin_base
        self.backend = backend
        if backend == "process":
            paths = [
                getattr(t, "filename", None) for t in getattr(master, "tables", [])
            ]
            if not paths or any(p is None for p in paths):
                raise ValueError(
                    "prefetch_backend='process' requires mmap-backed master "
                    "tables (MasterTables(mmap_dir=...)); in-RAM tables are "
                    "only shareable with the thread backend"
                )
            self._table_paths = [str(p) for p in paths]
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    # -- window processing ---------------------------------------------------
    @staticmethod
    def _table_parts(window: List, t: int) -> List[np.ndarray]:
        parts = []
        for entry in window:
            if isinstance(entry, tuple):
                ls_i, mask = entry
                parts.append(ls_i[t][mask[t]])
            else:
                parts.append(entry[t].reshape(-1))
        return parts

    def _process_window(self, window: List, pool, epoch: int = 0,
                        start_j: int = 0) -> WindowData:
        # window entries are ls_i [T, B] or (ls_i [T, B, P], mask)
        num_tables = (
            window[0][0].shape[0] if isinstance(window[0], tuple) else window[0].shape[0]
        )

        if self.backend == "process":
            futs = [
                pool.submit(_process_worker_gather, t, self._table_parts(window, t))
                for t in range(num_tables)
            ]
            results = [f.result() for f in futs]
        else:

            def one_table(t: int):
                idx = np.concatenate(self._table_parts(window, t))
                # direct-table fast path only for full in-RAM masters (sharded
                # masters hold owned slices indexed by LOCAL offsets)
                tab = (
                    self.master.tables
                    if isinstance(self.master, MasterTables)
                    else None
                )
                if native.available():
                    n_rows = int(self.master.ln_emb[t])
                    if tab is not None and tab[t].flags["C_CONTIGUOUS"]:
                        # fused sorted-unique + row gather in one native call
                        return native.unique_gather_f32(idx, tab[t], n_rows)
                    uniq = native.unique_i64(idx, n_rows)
                else:
                    uniq = np.unique(idx)  # sorted, like torch.unique
                return uniq, self.master.gather(t, uniq)

            results = list(pool.map(one_table, range(num_tables)))
        uniques = [r[0] for r in results]

        plan_spec = None
        if self.shadow is not None:
            if self._windows_produced == 0 and self.skip_first_plan:
                pass  # plan already in the shadow's (checkpointed) state
            else:
                plan_spec = self.shadow.plan_insert_spec(uniques)
        hot_slots = None
        stats = None
        if self.stats_spec is not None and self.shadow is not None:
            if self.stats_spec[3] > 0:
                hot_slots = self._select_hot(window, self.stats_spec[3])
            stats = self._window_stats(window, pool, hot_slots)
        self._windows_produced += 1
        return WindowData(
            uniques=uniques,
            rows=[r[1] for r in results],
            num_batches=len(window),
            plan_spec=plan_spec,
            stats=stats,
            start_epoch=epoch,
            start_j=start_j,
            hot_slots=hot_slots,
        )

    def _select_hot(self, window: List, h: int) -> np.ndarray:
        """Pick the window's hot set: up to ``h - 1`` POST-plan resident
        cache rows with the highest sampled lookup frequency (the last hot
        position is reserved for the trash row, WindowData.hot_slots doc).
        Sampling is an even deterministic stride over the window's batch
        entries capped at HOT_SAMPLE_CAP lookups — identical on every host
        and across checkpoint resumes."""
        first = window[0]
        ls0 = first[0] if isinstance(first, tuple) else first
        per_entry = int(np.prod(ls0.shape))
        stride = max(1, (len(window) * per_entry) // max(1, HOT_SAMPLE_CAP))
        sample = window[::stride]
        t_count = ls0.shape[0]
        cand_counts: List[np.ndarray] = []
        cand_slots: List[np.ndarray] = []
        for t in range(t_count):
            parts = self._table_parts(sample, t)
            ids = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            if ids.size == 0:
                continue
            u, c = np.unique(ids, return_counts=True)
            if u.size > h - 1:  # per-table top can't beat the global top
                keep = np.argpartition(c, u.size - (h - 1))[-(h - 1):]
                u, c = u[keep], c[keep]
            slots = self.shadow.resident_slots(t, u)
            res = slots >= 0
            cand_counts.append(c[res])
            cand_slots.append(slots[res])
        if not cand_slots:
            return np.zeros(0, np.int64)
        counts = np.concatenate(cand_counts)
        slots = np.concatenate(cand_slots)
        if counts.size > h - 1:
            keep = np.argpartition(counts, counts.size - (h - 1))[-(h - 1):]
            slots = slots[keep]
        return np.sort(slots)

    def _window_stats(self, window: List, pool, hot_slots=None):
        """Post-plan probe statistics of every (replica, batch) slice in the
        window (see WindowData.stats). The shadow is read-only here; batch
        entries parallelize over the worker pool (thread backend — the
        counting kernels release the GIL; the process backend counts on this
        thread, its workers cannot see the shadow)."""
        from cdlrm_tpu.cache.host_cache import WindowStats

        ndev, b_loc, want_uniq = self.stats_spec[:3]
        shadow = self.shadow

        def one_entry(entry):
            ls, mask = entry if isinstance(entry, tuple) else (entry, None)
            t_count = ls.shape[0]
            wm = wu = wc = tl = tu = 0
            for r in range(ndev):
                sl = slice(r * b_loc, (r + 1) * b_loc)
                v = (
                    None if mask is None
                    else mask[:, sl].reshape(t_count, -1)
                )
                ls_r = ls[:, sl].reshape(t_count, -1)
                n_lk = ls_r.size if v is None else int(v.sum())
                if want_uniq or hot_slots is not None:
                    m, u, c = shadow.count_probe_stats(
                        ls_r, valid=v, want_uniq=want_uniq,
                        hot_slots=hot_slots,
                    )
                    wu = max(wu, u)
                    wc = max(wc, c)
                    tu += u
                else:
                    m = shadow.count_misses(ls_r, valid=v)
                wm = max(wm, m)
                tl += n_lk
            return wm, wu, wc, tl, tu

        if self.backend == "process":
            parts = [one_entry(e) for e in window]
        else:
            parts = list(pool.map(one_entry, window))
        stats = WindowStats()
        for wm, wu, wc, tl, tu in parts:
            stats.worst_miss = max(stats.worst_miss, wm)
            stats.worst_uniq = max(stats.worst_uniq, wu)
            stats.worst_cold = max(stats.worst_cold, wc)
            stats.total_lookups += tl
            stats.total_uniq += tu
        return stats

    def _make_pool(self):
        pin = affinity.make_pin(self.worker_pin_base)
        if self.backend == "process":
            return ProcessPoolExecutor(
                max_workers=self.cache_workers,
                initializer=_process_worker_init,
                initargs=(self._table_paths, pin),
            )
        if pin is not None:
            return ThreadPoolExecutor(
                max_workers=self.cache_workers,
                initializer=_worker_pin,
                initargs=pin,
            )
        return ThreadPoolExecutor(max_workers=self.cache_workers)

    def run(self) -> None:
        if self.pin_core is not None:
            _pin_current_thread(self.pin_core)
        try:
            with self._make_pool() as pool:
                for epoch in range(self.start_epoch, self.nepochs):
                    skip = self.skip_batches if epoch == self.start_epoch else 0
                    window: List = []
                    j = skip  # full-batch index of the NEXT stream batch
                    for ls_i in _stream_iter(
                        self.cache_stream_fn, skip, epoch
                    ):
                        if self._stop_event.is_set():
                            return
                        window.append(ls_i)
                        j += 1
                        if len(window) == self.lookahead:
                            self.fifo.put(self._process_window(
                                window, pool, epoch, j - len(window)))
                            window = []
                    if window:
                        self.fifo.put(self._process_window(
                            window, pool, epoch, j - len(window)))
        except BaseException as e:  # surfaced by .get_window()
            self.error = e
        finally:
            self.fifo.put(_SENTINEL)

    # -- consumer API ----------------------------------------------------------
    def get_window(self, timeout: Optional[float] = None) -> Optional[WindowData]:
        """Blocking pop; None = stream exhausted. Re-raises pipeline errors."""
        item = self.fifo.get(timeout=timeout)
        if item is _SENTINEL:
            if self.error is not None:
                raise self.error
            return None
        return item

    def stop(self) -> None:
        self._stop_event.set()
        # drain so a blocked put() wakes up
        try:
            while True:
                self.fifo.get_nowait()
        except queue.Empty:
            pass
