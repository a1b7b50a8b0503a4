"""Master-resident row-wise AdaGrad state (Config.adagrad_master_state):
evicted ids' accumulators write back to a host AccumulatorStore with their
rows, and inserted ids RESUME their state instead of restarting — targeting
the thrash gap (with cache-resident-only state, AdaGrad loses several times
SGD's AUC under cache pressure). Beyond parity: the reference
trains SGD only (/root/reference/main_no_ddp.py:374-376).

Layers pinned here:
  - the refill step's state round-trip (exact, step-level),
  - AccumulatorStore gather/writeback/checkpoint payload,
  - the eviction thread's 4-tuple (rows + accs) writeback,
  - e2e: under real evictions the flag-ON trajectory tracks the
    full-table AdaGrad oracle measurably closer than flag-OFF, with the
    acc store demonstrably populated,
  - checkpoint round-trip restores the store.
"""

import queue

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cdlrm_tpu.cache.master import AccumulatorStore, MasterTables
from cdlrm_tpu.cache.prefetcher import EvictionManager
from cdlrm_tpu.config import Config
from cdlrm_tpu.data.synthetic import Batch
from cdlrm_tpu.parallel.mesh import make_dp_mesh
from cdlrm_tpu.train import step as step_lib
from cdlrm_tpu.train.trainer import CachedDlrmTrainer


def test_refill_step_round_trips_state():
    """make_refill_step with adagrad_master_state: evicted slots'
    accumulators come back PRE-insert (replica-0 broadcast, like the
    rows); inserted slots' accumulators equal the staged insert_acc;
    everything else follows replica 0 under the strict broadcast."""
    ndev, R, D = 4, 16, 8
    mesh = make_dp_mesh(ndev)
    scfg = step_lib.StepConfig(
        interaction_op="dot", loss_function="bce",
        optimizer="adagrad", adagrad_master_state=True,
    )
    refill = step_lib.make_refill_step(mesh, scfg)
    lead = NamedSharding(mesh, P("dp"))
    rng = np.random.default_rng(0)
    cache0 = rng.normal(size=(ndev * R, D)).astype(np.float32)
    acc0 = rng.random((ndev * R,)).astype(np.float32)
    cache = jax.device_put(jnp.asarray(cache0), lead)
    accum = jax.device_put(jnp.asarray(acc0), lead)
    ins_slots = np.array([3, 5], np.int32)
    ins_rows = np.full((2, D), 7.0, np.float32)
    ins_acc = np.array([0.25, 1.5], np.float32)
    ev_slots = np.array([3, 9], np.int32)
    cache, accum, evicted, ev_acc = refill(
        cache, jnp.asarray(ins_slots), jnp.asarray(ins_rows),
        jnp.asarray(ev_slots), accum, jnp.asarray(ins_acc),
    )
    ev_acc = np.asarray(ev_acc).reshape(ndev, -1)
    acc_out = np.asarray(accum).reshape(ndev, R)
    # evicted acc values are replica 0's PRE-insert state
    np.testing.assert_allclose(ev_acc[0], acc0[[3, 9]])
    # inserted slots resume the staged state on every replica
    for r in range(ndev):
        np.testing.assert_allclose(acc_out[r][[3, 5]], ins_acc)
        # non-inserted slots follow replica 0 (strict broadcast)
        keep = np.setdiff1d(np.arange(R), ins_slots)
        np.testing.assert_allclose(acc_out[r][keep], acc0[keep])


def test_accumulator_store_unit():
    store = AccumulatorStore([10, 20])
    store.writeback(0, np.array([2, 7]), np.array([1.5, 2.5], np.float32))
    store.writeback(1, np.array([19]), np.array([9.0], np.float32))
    got = store.gather(
        np.array([0, 1, 0, 1]), np.array([7, 19, 3, 0])
    )
    np.testing.assert_allclose(got, [2.5, 9.0, 0.0, 0.0])
    # checkpoint payload round-trips through a fresh store
    fresh = AccumulatorStore([10, 20])
    fresh.load_payload(store.payload())
    for a, b in zip(store.accs, fresh.accs):
        np.testing.assert_array_equal(a, b)


def test_eviction_manager_writes_acc_with_rows():
    ln = np.array([30, 40])
    master = MasterTables(ln, dim=4)
    store = AccumulatorStore(ln)
    fifo: "queue.Queue" = queue.Queue()
    mgr = EvictionManager(master, fifo, acc_store=store, timeout=5.0)
    mgr.start()
    tables = np.array([0, 1, 0])
    idxs = np.array([5, 33, 6])
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    accs = np.array([0.5, 1.25, 2.0], np.float32)
    fifo.put((tables, idxs, lambda: rows, lambda: accs))
    assert mgr.flush(timeout=10.0)
    np.testing.assert_allclose(master.gather(0, np.array([5, 6])), rows[[0, 2]])
    np.testing.assert_allclose(store.accs[0][[5, 6]], [0.5, 2.0])
    np.testing.assert_allclose(store.accs[1][33], 1.25)
    # legacy 3-tuples (no acc) keep working alongside
    fifo.put((np.array([1]), np.array([2]), lambda: rows[:1]))
    assert mgr.flush(timeout=10.0)
    np.testing.assert_allclose(master.gather(1, np.array([2])), rows[:1])
    # the 5s idle timeout retires the daemon thread on its own


LN = np.array([512])
IDS_PER_SET = 68  # = cache_sets(17) * ways(4): each window claims EVERY way
N_SETS = 4  # reuse gap 4 windows > fifo-lead + 2 (see _CycleStream doc)
BATCH = 24
WINDOW = 3  # batches per lookahead window (72 lookups >= 68 ids)


class _CycleStream:
    """Window w draws ids ONLY from set_{w mod 4}: disjoint CONTIGUOUS
    68-id ranges over a 17-set x 4-way cache, so every window's inserts
    claim exactly all 4 ways of every cache set — the ENTIRE previous
    window's residents evict at each boundary (no partial evictions
    leaking across later boundaries), every window is fully covered by
    its refill (hit rate 1.0 — no aux lanes whose updates are discarded),
    and an id's reuse comes 4 windows after its last use — beyond the
    prefetcher's gather lead at batch_fifo_size=1 (gather of window w
    starts only after boundary w-2 started, hence after boundary w-3
    completed), so with SYNCHRONOUS writeback every regathered
    (row, state) pair is durable before its gather (the test
    monkeypatches the fifo to apply writebacks inline at the
    boundary)."""

    m_den = 13

    def __init__(self, n_batches, seed=5):
        self.ln_emb = LN
        self.num_batches = n_batches

    def __len__(self):
        return self.num_batches

    def batches(self, skip: int = 0):
        for j in range(skip, self.num_batches):
            rng = np.random.default_rng([11, j])
            w = j // WINDOW
            base = (w % N_SETS) * IDS_PER_SET
            # the window's 3x24 lookups cover ALL 68 ids (a permutation +
            # 4 extras, windowed-seeded): every window inserts the full
            # set, claiming every way — full eviction at every boundary
            wrng = np.random.default_rng([13, w])
            seq = np.concatenate([
                wrng.permutation(IDS_PER_SET),
                wrng.integers(0, IDS_PER_SET, WINDOW * BATCH - IDS_PER_SET),
            ]) + base
            ls = seq[(j % WINDOW) * BATCH: (j % WINDOW + 1) * BATCH][None, :]
            x = rng.random((BATCH, self.m_den)).astype(np.float32)
            y = (x[:, :1] > 0.5).astype(np.float32)
            yield Batch(x, ls, None, y)


def _run_cached(master_state: bool, steps=36):
    cfg = Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", mini_batch_size=BATCH, world_size=1,
        cache_size=16, num_ways=4,  # 17 prime sets x 4 ways = 68 rows
        loss_function="bce", lookahead=WINDOW, table_agg_freq=10_000,
        print_freq=1 << 20, learning_rate=0.05, lr_embeds=0.1,
        optimizer="adagrad", dedup_lookups="on", adagrad_eps=1e-2,
        adagrad_master_state=master_state, batch_fifo_size=1,
        refill_prestage=False, round_targets=True,
    )
    cfg.finalize(ln_emb=LN)
    ds = _CycleStream(steps + WINDOW)
    tr = CachedDlrmTrainer(cfg, ds, mesh=make_dp_mesh(1))
    # SYNCHRONOUS writeback: boundary-time durability so the reuse-gap
    # argument in _CycleStream's docstring holds deterministically
    tr.eviction_manager.start = lambda: None
    real_put = tr.eviction_fifo.put
    tr.eviction_fifo.put = lambda item: tr.eviction_manager._apply(item)
    tables0 = [t.copy() for t in tr.master.tables]
    p0 = {
        k: [(np.asarray(w).copy(), np.asarray(b).copy()) for w, b in v]
        for k, v in step_lib.unreplicate(tr.params).items()
    }
    try:
        tr.train(max_steps=steps, log_fn=lambda s: None)
        hit = tr.metrics.hit_rate
        params = {
            k: [(np.asarray(w), np.asarray(b))
                for w, b in v] for k, v in
            step_lib.unreplicate(tr.params).items()
        }
        store = tr._acc_master
        nonzero = (
            sum(int(np.count_nonzero(a)) for a in store.accs)
            if store is not None else 0
        )
    finally:
        tr.eviction_fifo.put = real_put
        tr.close()
    return hit, params, nonzero, tables0, p0


def _longhand_oracle(tables0, p0, steps=36):
    """Full-table row-wise AdaGrad, longhand (the pattern of
    test_trainer_e2e.test_adagrad_equals_hand_oracle_when_fully_resident),
    from the CACHED trainer's exact initial state."""
    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward

    eps = 1e-2
    tables = [jnp.asarray(t) for t in tables0]
    params_o = {k: [(jnp.asarray(w), jnp.asarray(b)) for w, b in v]
                for k, v in p0.items() if k in ("bot", "top")}
    acc_p = {k: [(jnp.zeros_like(w), jnp.zeros_like(b)) for w, b in v]
             for k, v in params_o.items()}
    acc_t = [jnp.zeros(t.shape[0]) for t in tables]
    ds = _CycleStream(steps + WINDOW)
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        x, tgt = jnp.asarray(batch.x), jnp.asarray(batch.y)
        ls = batch.ls_i

        def loss_fn(params, tables):
            ly = jnp.stack([tables[0][ls[0]]])
            p = dlrm_forward(params, x, ly, "dot", False, 0.0)
            return compute_loss(p, tgt, "bce")

        g_p, g_t = jax.grad(loss_fn, argnums=(0, 1))(params_o, tables)
        new_p, new_a = {}, {}
        for k, v in params_o.items():
            new_p[k], new_a[k] = [], []
            for (w, bb), (gw, gb), (aw, ab) in zip(v, g_p[k], acc_p[k]):
                aw, ab = aw + gw * gw, ab + gb * gb
                new_p[k].append((w - 0.05 * gw / (jnp.sqrt(aw) + eps),
                                 bb - 0.05 * gb / (jnp.sqrt(ab) + eps)))
                new_a[k].append((aw, ab))
        params_o, acc_p = new_p, new_a
        new_t, new_at = [], []
        for t, gt, at in zip(tables, g_t, acc_t):
            at = at + jnp.mean(gt * gt, axis=1)
            new_t.append(t - 0.1 * gt / (jnp.sqrt(at) + eps)[:, None])
            new_at.append(at)
        tables, acc_t = new_t, new_at
    return {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
            for k, v in params_o.items()}


def _param_dist(pa, pb):
    m = 0.0
    for k in ("bot", "top"):
        for (wa, ba), (wb, bb) in zip(pa[k], pb[k]):
            m = max(m, float(np.max(np.abs(wa - wb))),
                    float(np.max(np.abs(ba - bb))))
    return m


@pytest.mark.slow
def test_master_state_tracks_oracle_under_eviction():
    hit_on, params_on, nonzero_on, tables0, p0 = _run_cached(True)
    hit_off, params_off, nonzero_off, tables0b, p0b = _run_cached(False)
    # both runs started from the identical initial state (same seeds)
    for a, b in zip(tables0, tables0b):
        np.testing.assert_array_equal(a, b)
    params_oracle = _longhand_oracle(tables0, p0)
    # the regime held: fully-covered windows, no discarded aux updates
    assert hit_on == pytest.approx(1.0) and hit_off == pytest.approx(1.0)
    # state actually round-tripped (evictions happened, store populated)
    assert nonzero_on > 0
    assert nonzero_off == 0
    # the flag-ON dense params track the full-table AdaGrad oracle to
    # float exactness (state resumes across evict/reinsert: the (value,
    # acc) pair round-trips f32-exact through the masters); flag-OFF
    # restarts state at every reinsert and lands orders of magnitude
    # farther (measured 1.5e-7 vs 7.7e-5 at these 36 steps)
    dist_on = _param_dist(params_on, params_oracle)
    dist_off = _param_dist(params_off, params_oracle)
    assert dist_on < 1e-6, dist_on
    assert dist_off > 100 * dist_on, (dist_on, dist_off)


@pytest.mark.slow
def test_master_state_checkpoint_roundtrip(tmp_path):
    cfg = Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", mini_batch_size=BATCH, world_size=1,
        cache_size=16, num_ways=4, loss_function="bce", lookahead=WINDOW,
        table_agg_freq=10_000, print_freq=1 << 20, learning_rate=0.05,
        lr_embeds=0.1, optimizer="adagrad", dedup_lookups="on",
        adagrad_eps=1e-2, adagrad_master_state=True, batch_fifo_size=2,
        refill_prestage=False, round_targets=True,
    )
    cfg.finalize(ln_emb=LN)
    ds = _CycleStream(40)
    tr = CachedDlrmTrainer(cfg, ds, mesh=make_dp_mesh(1))
    try:
        tr.train(max_steps=24, log_fn=lambda s: None)
        tr.save_checkpoint(str(tmp_path / "ck"))
        saved = [a.copy() for a in tr._acc_master.accs]
        assert sum(int(np.count_nonzero(a)) for a in saved) > 0
    finally:
        tr.close()
    tr2 = CachedDlrmTrainer(cfg, _CycleStream(40), mesh=make_dp_mesh(1))
    try:
        tr2.load_checkpoint(str(tmp_path / "ck"))
        for a, b in zip(saved, tr2._acc_master.accs):
            np.testing.assert_array_equal(a, b)
    finally:
        tr2.close()


def test_refill_inputs_fence_waits_for_inflight_writeback():
    """_refill_device_inputs flushes the eviction fifo BEFORE gathering
    resume accumulators: an id evicted at boundary w and reinserted at
    w+1 (the thrash regime) must resume its written-back state even when
    the eviction thread is still draining — without the fence the gather
    silently reads the stale 0.0 (= drop-at-evict) value."""
    import time

    from cdlrm_tpu.cache.host_cache import InsertPlan

    cfg = Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", mini_batch_size=BATCH, world_size=1,
        cache_size=16, num_ways=4, loss_function="bce", lookahead=WINDOW,
        table_agg_freq=10_000, print_freq=1 << 20, optimizer="adagrad",
        dedup_lookups="on", adagrad_master_state=True, batch_fifo_size=1,
        refill_prestage=False, round_targets=True,
    )
    cfg.finalize(ln_emb=LN)
    tr = CachedDlrmTrainer(cfg, _CycleStream(8), mesh=make_dp_mesh(1))
    try:
        # slow the eviction thread so the writeback is genuinely in
        # flight when the gather runs
        real_apply = tr.eviction_manager._apply

        def slow_apply(item):
            time.sleep(0.3)
            real_apply(item)

        tr.eviction_manager._apply = slow_apply
        d = cfg.arch_sparse_feature_size
        tr.eviction_fifo.put((
            np.array([0], np.int32), np.array([7], np.int64),
            lambda: np.full((1, d), 2.0, np.float32),
            lambda: np.array([3.25], np.float32),
        ))
        plan = InsertPlan(
            insert_slots=np.array([5], np.int32),
            insert_rows=np.zeros((1, d), np.float32),
            evict_slots=np.zeros(0, np.int32),
            evict_tables=np.zeros(0, np.int32),
            evict_idxs=np.zeros(0, np.int64),
            insert_tables=np.array([0], np.int32),
            insert_ids=np.array([7], np.int64),
        )
        ops = tr._refill_device_inputs(plan)
        acc_op = np.asarray(ops[3])
        assert acc_op[0] == np.float32(3.25), (
            f"fence did not wait for the in-flight writeback: resumed "
            f"acc {acc_op[0]} (stale), wanted 3.25"
        )
        # the row writeback from the same item is durable too
        np.testing.assert_array_equal(
            tr.master.tables[0][7], np.full(d, 2.0, np.float32)
        )
    finally:
        tr.eviction_manager._apply = real_apply
        tr.close()


def test_stager_defers_acc_gather_to_boundary_fence():
    """The _WindowStager thread races the previous boundary's eviction
    ENQUEUE (it stages window w+1 while _apply_refill(w) is still
    running), so a fence on that thread could flush an empty fifo and
    read a stale accumulator. The stager therefore stages only the 3
    row operands (stage_acc=False) and the boundary completes the tuple
    behind a main-thread fence (_complete_staged_acc) — pinned here with
    an in-flight slow writeback, like the direct-fence test above."""
    import time

    from cdlrm_tpu.cache.host_cache import InsertPlan

    cfg = Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", mini_batch_size=BATCH, world_size=1,
        cache_size=16, num_ways=4, loss_function="bce", lookahead=WINDOW,
        table_agg_freq=10_000, print_freq=1 << 20, optimizer="adagrad",
        dedup_lookups="on", adagrad_master_state=True, batch_fifo_size=1,
        refill_prestage=True, round_targets=True,
    )
    cfg.finalize(ln_emb=LN)
    tr = CachedDlrmTrainer(cfg, _CycleStream(8), mesh=make_dp_mesh(1))
    try:
        d = cfg.arch_sparse_feature_size
        plan = InsertPlan(
            insert_slots=np.array([5], np.int32),
            insert_rows=np.zeros((1, d), np.float32),
            evict_slots=np.zeros(0, np.int32),
            evict_tables=np.zeros(0, np.int32),
            evict_idxs=np.zeros(0, np.int64),
            insert_tables=np.array([0], np.int32),
            insert_ids=np.array([7], np.int64),
        )
        # what the stager stages: NO acc operand
        staged = tr._refill_device_inputs(plan, stage_acc=False)
        assert len(staged) == 3
        # slow in-flight writeback, enqueued AFTER staging (the race the
        # boundary-time completion exists for)
        real_apply = tr.eviction_manager._apply

        def slow_apply(item):
            time.sleep(0.3)
            real_apply(item)

        tr.eviction_manager._apply = slow_apply
        tr.eviction_fifo.put((
            np.array([0], np.int32), np.array([7], np.int64),
            lambda: np.full((1, d), 2.0, np.float32),
            lambda: np.array([4.5], np.float32),
        ))
        done = tr._complete_staged_acc(plan, staged)
        assert len(done) == 4
        assert np.asarray(done[3])[0] == np.float32(4.5), (
            "boundary completion did not wait for the in-flight writeback"
        )
    finally:
        tr.eviction_manager._apply = real_apply
        tr.close()


def test_config_guard():
    cfg = Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", adagrad_master_state=True,
    )
    with pytest.raises(ValueError, match="adagrad_master_state"):
        cfg.finalize(ln_emb=LN)
