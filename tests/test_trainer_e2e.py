"""End-to-end: cached trainer on synthetic data over the 8-device CPU mesh —
training progress on a learnable signal, hit-rate accounting, checkpoint
resume equivalence, config plumbing."""

import numpy as np
import pytest

from cdlrm_tpu.config import Config, config_from_args
from cdlrm_tpu.data.synthetic import Batch, SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer


class LearnableDataset:
    """Synthetic stream whose target depends on a dense feature, so loss must
    decrease under training."""

    def __init__(self, ln_emb, m_den=13, num_batches=40, batch=64, seed=0):
        self.ln_emb = np.asarray(ln_emb)
        self.m_den = m_den
        self.num_batches = num_batches
        self.batch = batch
        self.seed = seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            ls_i = np.stack(
                [rng.integers(0, n, self.batch) for n in self.ln_emb]
            )
            y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
            yield Batch(x, ls_i, None, y)


def make_cfg(**kw):
    base = dict(
        arch_sparse_feature_size=8,
        arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1",
        mini_batch_size=64,
        world_size=8,
        cache_size=64,
        num_ways=4,
        loss_function="bce",
        lookahead=4,
        table_agg_freq=10,
        print_freq=1000,
        learning_rate=0.2,
        lr_embeds=0.2,
    )
    base.update(kw)
    cfg = Config(**base)
    cfg.finalize(ln_emb=np.array([500, 200, 1000]))
    return cfg


def test_train_loss_decreases_and_hit_rate():
    cfg = make_cfg()
    ds = LearnableDataset(cfg.ln_emb, num_batches=80)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=20, log_fn=lambda s: None)
    early_loss = tr.metrics.loss_sum / tr.metrics.examples
    tr.metrics.loss_sum = tr.metrics.correct = 0.0
    tr.metrics.examples = tr.metrics.steps = 0
    m = tr.train(max_steps=80, log_fn=lambda s: None)
    tr.close()
    late_loss = m.loss_sum / m.examples
    assert tr.global_step == 80
    # learnable signal: loss must drop from the untrained start
    assert late_loss < early_loss
    assert 0.0 < m.hit_rate <= 1.0
    assert m.refills == 20  # 80 steps / lookahead 4


def test_eval_runs_and_returns_auc():
    cfg = make_cfg(test_freq=-1)
    ds = LearnableDataset(cfg.ln_emb, num_batches=30)
    tr = CachedDlrmTrainer(cfg, ds, LearnableDataset(cfg.ln_emb, num_batches=4, seed=9))
    tr.train(max_steps=30, log_fn=lambda s: None)
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    tr.close()
    assert 0.0 <= acc <= 1.0
    assert auc > 0.5  # learnable signal


def test_checkpoint_resume_bitexact(tmp_path):
    cfg = make_cfg()
    ds = LearnableDataset(cfg.ln_emb, num_batches=40)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=20, log_fn=lambda s: None)
    ck = str(tmp_path / "ckpt")
    tr.save_checkpoint(ck)
    cache_before = np.asarray(tr.cache[0]).copy()
    occ_before = [o.copy() for o in tr.controller.occupancy]
    tr.close()

    cfg2 = make_cfg()
    tr2 = CachedDlrmTrainer(cfg2, ds, ds)
    tr2.load_checkpoint(ck)
    np.testing.assert_allclose(np.asarray(tr2.cache[0]), cache_before)
    for a, b in zip(tr2.controller.occupancy, occ_before):
        np.testing.assert_array_equal(a, b)
    assert tr2.global_step == 20
    # resumed trainer can continue training
    tr2.train(max_steps=25, log_fn=lambda s: None)
    tr2.close()
    assert tr2.global_step >= 25


def test_dirty_master_checkpoint(tmp_path):
    """checkpoint_masters='dirty' (the default): masters restore
    bit-exactly from (init + dirty rows), the file scales with rows
    written back instead of table size, a mismatched seed is refused, and
    a re-saved checkpoint after resume stays cumulative (round-3 verdict
    item 4)."""
    import os

    cfg = make_cfg()
    assert cfg.checkpoint_masters == "dirty"
    ds = LearnableDataset(cfg.ln_emb, num_batches=60)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=24, log_fn=lambda s: None)
    ck = str(tmp_path / "ckpt")
    tr.save_checkpoint(ck)
    assert tr.eviction_manager.rows_written > 0, "no evictions — test is vacuous"
    masters_before = [t.copy() for t in tr.master.tables]

    # size scales with rows written, not table rows: bounded by a direct
    # per-dirty-row accounting (idx int64 + dim float32 values + npz
    # overhead), and strictly under the full dump even at this toy
    # geometry where >half the rows are dirty
    full = str(tmp_path / "full.npz")
    tr.master.save(full)
    dirty_sz = os.path.getsize(os.path.join(ck, "master.npz"))
    full_sz = os.path.getsize(full)
    n_dirty = tr.master._dirty.total_rows()
    n_rows = int(np.sum(cfg.ln_emb))
    assert 0 < n_dirty < n_rows
    assert dirty_sz < n_dirty * (cfg.m_spa * 4 + 8) * 1.2 + 4096, (
        dirty_sz, n_dirty,
    )
    assert dirty_sz < full_sz
    tr.close()

    # bit-exact restore onto a freshly-initialized master
    tr2 = CachedDlrmTrainer(make_cfg(), ds, ds)
    tr2.load_checkpoint(ck)
    for a, b in zip(tr2.master.tables, masters_before):
        np.testing.assert_array_equal(a, b)

    # cumulative: continue, re-save, restore in a THIRD trainer — rows
    # dirtied before the first checkpoint must still be present
    tr2.train(max_steps=48, log_fn=lambda s: None)
    ck2 = str(tmp_path / "ckpt2")
    tr2.save_checkpoint(ck2)
    masters_2 = [t.copy() for t in tr2.master.tables]
    tr2.close()
    tr3 = CachedDlrmTrainer(make_cfg(), ds, ds)
    tr3.load_checkpoint(ck2)
    for a, b in zip(tr3.master.tables, masters_2):
        np.testing.assert_array_equal(a, b)
    tr3.close()

    # seed guard: a different procedural base must refuse the dirty file
    tr4 = CachedDlrmTrainer(make_cfg(numpy_rand_seed=999), ds, ds)
    with pytest.raises(ValueError, match="init token"):
        tr4.load_checkpoint(ck)
    tr4.close()


def test_full_master_checkpoint_mode(tmp_path):
    """checkpoint_masters='full' keeps the round-3 full-dump format and
    restores identically."""
    cfg = make_cfg(checkpoint_masters="full")
    ds = LearnableDataset(cfg.ln_emb, num_batches=40)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=16, log_fn=lambda s: None)
    ck = str(tmp_path / "ckpt")
    tr.save_checkpoint(ck)
    masters_before = [t.copy() for t in tr.master.tables]
    tr.close()
    tr2 = CachedDlrmTrainer(make_cfg(checkpoint_masters="full"), ds, ds)
    tr2.load_checkpoint(ck)
    for a, b in zip(tr2.master.tables, masters_before):
        np.testing.assert_array_equal(a, b)
    tr2.close()


@pytest.mark.parametrize("scan,hot,opt", [
    (1, 0, "sgd"), (3, 0, "sgd"), (3, 16, "sgd"),
    (3, 0, "adagrad"),  # optimizer state (embed_acc + dense_acc) must
    # checkpoint/restore and keep the resumed trajectory step-identical
])
def test_midstream_resume_equals_uninterrupted(tmp_path, scan, hot, opt):
    """(train 18, checkpoint, fresh trainer, resume 20 more) must be
    step-for-step identical to an uninterrupted train-38 — including refill
    windows and prefetcher alignment (the data cursor).
    18 is deliberately mid-window (lookahead 4). Fully-resident geometry
    keeps the comparison exact: no miss-row staging races with eviction
    writebacks. scan=3: resume lands mid-block, cadences and window buckets
    must still align. hot=16: the resumed shadow must skip the cursor
    window's plan yet re-derive the SAME hot list and cold bucket (the
    deterministic strided sample depends only on window content)."""
    ln_emb = np.array([40, 25, 60])
    b = 16

    def cfg_fn():
        cfg = make_cfg(
            mini_batch_size=b, world_size=4, cache_size=64, num_ways=2,
            lookahead=4, table_agg_freq=5, scan_steps=scan,
            hot_tier_rows=hot, optimizer=opt,
            dedup_lookups=(
                "on" if opt == "adagrad" else "auto" if hot else "off"
            ),
        )
        cfg.finalize(ln_emb=ln_emb)
        return cfg

    def ds_fn():
        from cdlrm_tpu.data.synthetic import SyntheticDataset

        return SyntheticDataset(
            m_den=13, ln_emb=ln_emb, data_size=b * 50, mini_batch_size=b,
            num_indices_per_lookup=1, num_indices_per_lookup_fixed=True,
            round_targets=True, seed=11,
        )

    # uninterrupted run
    tr = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr.train(max_steps=38, log_fn=lambda s: None)
    cache_ref = np.asarray(tr.cache).copy()
    acc_ref = (np.asarray(tr.embed_acc).copy() if opt == "adagrad" else None)
    occ_ref = [o.copy() for o in tr.controller.occupancy]
    params_ref = {k: [(np.asarray(w), np.asarray(bb)) for w, bb in v]
                  for k, v in tr.params.items()}
    tr.close()

    # interrupted at 18 (mid-window), resumed in a FRESH trainer
    tr1 = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr1.train(max_steps=18, log_fn=lambda s: None)
    assert tr1._cursor == (0, 18)
    ck = str(tmp_path / "mid")
    tr1.save_checkpoint(ck)
    tr1.close()

    tr2 = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr2.load_checkpoint(ck)
    assert tr2._cursor == (0, 18)
    tr2.train(max_steps=38, log_fn=lambda s: None)
    assert tr2.global_step == 38
    tr2.close()

    for a, bb in zip(tr2.controller.occupancy, occ_ref):
        np.testing.assert_array_equal(a, bb)
    np.testing.assert_allclose(np.asarray(tr2.cache), cache_ref, rtol=1e-6,
                               atol=1e-7)
    if opt == "adagrad":
        np.testing.assert_allclose(
            np.asarray(tr2.embed_acc), acc_ref, rtol=1e-6, atol=1e-7
        )
    for k in ("bot", "top"):
        for (w, bi), (wo, bo) in zip(tr2.params[k], params_ref[k]):
            np.testing.assert_allclose(np.asarray(w), wo, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(np.asarray(bi), bo, rtol=1e-6, atol=1e-7)


def test_strict_bias_divergence_mode():
    cfg = make_cfg(strict_bias_divergence=True)
    ds = LearnableDataset(cfg.ln_emb, num_batches=10)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=10, log_fn=lambda s: None)
    # weights stay replicated; biases may diverge (the reference bug)
    w0 = np.asarray(tr.params["bot"][0][0])
    assert np.allclose(w0[0], w0[1])
    tr.close()


def test_config_cli_roundtrip():
    cfg = config_from_args(
        [
            "--arch-sparse-feature-size", "16",
            "--arch-mlp-bot", "13-32-16",
            "--arch-mlp-top", "16-1",
            "--mini-batch-size", "128",
            "--cache-size", "1000",
            "--num-ways", "8",
            "--loss-function", "bce",
            "--lookahead", "50",
            "--average-on-writeback",
        ]
    )
    assert cfg.arch_sparse_feature_size == 16
    assert cfg.cache_size == 1000
    assert cfg.average_on_writeback is True
    cfg.finalize(ln_emb=np.array([100, 200]))
    assert cfg.ln_top[0] == 3 * 2 // 2 + 16
    assert cfg.cache_sets == 1009  # next prime


def test_config_sanity_check_raises():
    cfg = Config(arch_sparse_feature_size=8, arch_mlp_bot="13-16", arch_mlp_top="4-1")
    with pytest.raises(ValueError, match="bottom MLP out"):
        cfg.finalize(ln_emb=np.array([10]))


@pytest.mark.parametrize("pooled,pack,srt", [
    (False, True, False), (True, True, False),
    (False, False, False), (True, False, False),  # unpacked wires
    # (pack_wire off): raw int32 ranks + global unique rows, no device
    # decode
    (False, False, True), (True, False, True),  # sorted unpacked wire
    # (Config.sorted_dedup_wire): ascending unique slots + remapped ranks,
    # indices_are_sorted scatters — must be a pure bucket permutation
])
def test_dedup_matches_plain_path(pooled, pack, srt):
    """The dedup wire format (rank stream + unique list, train/step.py
    body_dedup) must reproduce the plain path's training exactly: the
    scatter-add coalesces duplicate-slot gradients identically whether XLA
    does it (plain) or the take-transpose segment-sum does (dedup). Heavy
    duplication (tiny id range) stresses the coalescing.

    The geometry is deliberately eviction-heavy (70 ids into 11 sets x 4
    ways), and WHEN an eviction writeback lands in the master relative to
    the prefetcher's window gathers is timing-dependent BY DESIGN (async
    writeback thread — parity with the reference's cache manager process).
    An exact two-run comparison therefore freezes the master: the writeback
    thread is never started, so every miss reads identical (init) master
    values in both runs while the eviction/insert traffic itself is still
    fully exercised."""
    ln_emb = np.array([50, 20, 70])

    class DupHeavyDataset:
        m_den = 13

        def __init__(self, num_batches=24, batch=64, seed=4):
            self.ln_emb = ln_emb
            self.num_batches, self.batch, self.seed = num_batches, batch, seed

        def __len__(self):
            return self.num_batches

        def batches(self):
            rng = np.random.default_rng(self.seed)
            for _ in range(self.num_batches):
                x = rng.random((self.batch, self.m_den)).astype(np.float32)
                y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
                if pooled:
                    p = 3
                    ls = np.stack(
                        [rng.integers(0, n, (self.batch, p)) for n in ln_emb]
                    )
                    mask = rng.random((3, self.batch, p)) < 0.7
                    mask[:, :, 0] = True
                    yield Batch(x, ls, mask, y)
                else:
                    ls = np.stack(
                        [rng.integers(0, n, self.batch) for n in ln_emb]
                    )
                    yield Batch(x, ls, None, y)

    def run(dedup):
        cfg = make_cfg(
            world_size=4, cache_size=32, num_ways=4, lookahead=3,
            table_agg_freq=5, dedup_lookups=dedup, eviction_fifo_size=64,
            pack_wire=pack, sorted_dedup_wire=srt,
        )
        cfg.finalize(ln_emb=ln_emb)
        tr = CachedDlrmTrainer(cfg, DupHeavyDataset(), mesh=None)
        tr.eviction_manager.start = lambda: None  # freeze master (docstring)
        assert tr._dedup == dedup
        tr.train(max_steps=20, log_fn=lambda s: None)
        out = (
            np.asarray(tr.cache).copy(),
            {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
             for k, v in (tr.params or {}).items()},
            tr.metrics.loss_sum,
            tr.metrics.hits,
            tr.metrics.lookups,
        )
        tr.close()
        return out

    cache_p, params_p, loss_p, hits_p, lk_p = run(False)
    cache_d, params_d, loss_d, hits_d, lk_d = run(True)
    assert (hits_p, lk_p) == (hits_d, lk_d)
    np.testing.assert_allclose(loss_d, loss_p, rtol=1e-5)
    trash = -1  # last row: unspecified by contract (geometry.py)
    R = cache_p.shape[0] // 4
    keep = np.ones(cache_p.shape[0], bool)
    for r in range(4):
        keep[r * R + R - 1] = False
    np.testing.assert_allclose(cache_d[keep], cache_p[keep], rtol=1e-4,
                               atol=1e-6)
    for k in ("bot", "top"):
        for (w, b), (wo, bo) in zip(params_d[k], params_p[k]):
            np.testing.assert_allclose(w, wo, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(b, bo, rtol=1e-5, atol=1e-7)


def test_cached_equals_fulltable_when_fully_resident():
    """With cache >= table size on one device, the cached path's training
    dynamics must match plain full-table SGD exactly: every id becomes
    resident at the first refill, window-hit protection keeps trained rows
    from being overwritten by later refills, and the sparse row updates
    coincide with gathered-row SGD (the reference's semantics when nothing
    ever misses). This pins the whole cache machinery against a
    cache-free oracle."""
    import jax.numpy as jnp

    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward
    from cdlrm_tpu.parallel.mesh import make_dp_mesh
    from cdlrm_tpu.train import step as step_lib

    ln_emb = np.array([40, 25, 60])
    steps, b = 12, 16
    cfg = make_cfg(
        mini_batch_size=b, world_size=1, cache_size=64, num_ways=2,
        lookahead=3, table_agg_freq=10_000, learning_rate=0.1, lr_embeds=0.3,
    )
    cfg.finalize(ln_emb=ln_emb)
    assert all(int(n) <= cfg.cache_sets for n in ln_emb)  # fully resident

    ds = LearnableDataset(ln_emb, num_batches=steps + 2, batch=b, seed=3)
    mesh = make_dp_mesh(1)
    tr = CachedDlrmTrainer(cfg, ds, mesh=mesh)

    # oracle: identical init (same master values + same dense params)
    p0 = step_lib.unreplicate(tr.params)
    tables = [jnp.asarray(tr.master.tables[t].copy()) for t in range(3)]

    tr.train(max_steps=steps, log_fn=lambda s: None)

    params_o = {k: [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in v]
                for k, v in p0.items()}
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        x, tgt = jnp.asarray(batch.x), jnp.asarray(batch.y)
        ls = batch.ls_i

        def loss_fn(params, tables):
            ly = jnp.stack([tables[t][ls[t]] for t in range(3)])
            p = dlrm_forward(params, x, ly, "dot", False, 0.0)
            return compute_loss(p, tgt, cfg.loss_function)

        import jax

        (g_p, g_t) = jax.grad(loss_fn, argnums=(0, 1))(params_o, tables)
        params_o = {
            k: [(w - 0.1 * gw, bb - 0.1 * gb)
                for (w, bb), (gw, gb) in zip(v, g_p[k])]
            for k, v in params_o.items()
        }
        tables = [t - 0.3 * gt for t, gt in zip(tables, g_t)]

    got_p = step_lib.unreplicate(tr.params)
    for k in ("bot", "top"):
        for (w, bb), (wo, bo) in zip(got_p[k], params_o[k]):
            np.testing.assert_allclose(w, wo, rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(bb, bo, rtol=2e-4, atol=1e-6)

    # cache rows of every id SEEN IN THE STREAM must equal the oracle's
    # trained table rows (unseen ids are never inserted — cDLRM semantics)
    from cdlrm_tpu.parallel.mesh import local_shard

    seen = [set() for _ in range(3)]
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        for t in range(3):
            seen[t].update(batch.ls_i[t].tolist())
    cache = local_shard(tr.cache)
    for t in range(3):
        ids = np.array(sorted(seen[t]), dtype=np.int64)
        sets_t = int(tr.geo.sets[t])
        occ = tr.controller.occupancy[t]
        set_idx = ids % sets_t
        eq = occ[set_idx] == ids[:, None]
        assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
        way = eq.argmax(axis=1)
        slots = tr.geo.table_offsets[t] + way * sets_t + set_idx
        np.testing.assert_allclose(
            cache[slots], np.asarray(tables[t])[ids], rtol=2e-4, atol=1e-6
        )
    tr.close()


def test_cached_md_equals_md_oracle_when_fully_resident():
    """Cached MIXED-DIMENSION training (beyond-parity: the reference's
    cached path crashes with MD — its prefetcher reads E.weight,
    model_no_ddp.py:80-87 — and MD is exactly the regime where caching
    matters, huge row counts at small dims). Fully resident, the cached-MD
    trajectory must match manual MD-DLRM SGD exactly: compact [n_t, d_t]
    base rows trained at lr_embeds through the cache, per-table [d_t, D]
    projections trained at the dense lr, full-dim tables projection-free
    (frozen identity)."""
    import jax
    import jax.numpy as jnp

    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward
    from cdlrm_tpu.parallel.mesh import local_shard, make_dp_mesh
    from cdlrm_tpu.train import step as step_lib

    ln_emb = np.array([40, 25, 60])
    steps, b = 12, 16
    cfg = make_cfg(
        mini_batch_size=b, world_size=1, cache_size=64, num_ways=2,
        lookahead=3, table_agg_freq=10_000, learning_rate=0.1, lr_embeds=0.3,
        md_flag=True, md_temperature=1.0,
    )
    cfg.finalize(ln_emb=ln_emb)
    dims = cfg.m_spa_per_table
    D = cfg.m_spa
    assert any(d < D for d in dims), f"no compression at {dims} — vacuous"
    assert any(d == D for d in dims), "want a full-dim table to pin freezing"

    ds = LearnableDataset(ln_emb, num_batches=steps + 2, batch=b, seed=3)
    tr = CachedDlrmTrainer(cfg, ds, mesh=make_dp_mesh(1))

    # oracle gets IDENTICAL init: compact master rows + dense params + proj
    p0 = step_lib.unreplicate(tr.params)
    W = [jnp.asarray(tr.master.tables[t].copy()) for t in range(3)]
    proj0 = jnp.asarray(p0["md_proj"])
    Ps = [proj0[t, : dims[t]] for t in range(3)]

    tr.train(max_steps=steps, log_fn=lambda s: None)

    params_o = {k: [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in v]
                for k, v in p0.items() if k != "md_proj"}
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        x, tgt = jnp.asarray(batch.x), jnp.asarray(batch.y)
        ls = batch.ls_i

        def loss_fn(params, W, Ps):
            lys = []
            for t in range(3):
                e = W[t][ls[t]]
                if dims[t] < D:
                    e = e @ Ps[t]
                lys.append(e)
            p = dlrm_forward(params, x, jnp.stack(lys), "dot", False, 0.0)
            return compute_loss(p, tgt, cfg.loss_function)

        g_p, g_W, g_P = jax.grad(loss_fn, argnums=(0, 1, 2))(params_o, W, Ps)
        params_o = {
            k: [(w - 0.1 * gw, bb - 0.1 * gb)
                for (w, bb), (gw, gb) in zip(v, g_p[k])]
            for k, v in params_o.items()
        }
        W = [w - 0.3 * gw for w, gw in zip(W, g_W)]
        # projections are DENSE params (reference PrEmbeddingBag Linear):
        # dense lr; full-dim tables have no projection to train
        Ps = [p - (0.1 * gp if dims[t] < D else 0.0)
              for t, (p, gp) in enumerate(zip(Ps, g_P))]

    got_p = step_lib.unreplicate(tr.params)
    for k in ("bot", "top"):
        for (w, bb), (wo, bo) in zip(got_p[k], params_o[k]):
            np.testing.assert_allclose(w, wo, rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(bb, bo, rtol=2e-4, atol=1e-6)
    for t in range(3):
        if dims[t] < D:
            np.testing.assert_allclose(
                got_p["md_proj"][t, : dims[t]], Ps[t], rtol=2e-4, atol=1e-6
            )
            # pad rows of the projection never move off zero
            np.testing.assert_array_equal(got_p["md_proj"][t, dims[t]:], 0.0)
        else:
            # frozen identity for full-dim tables
            np.testing.assert_array_equal(got_p["md_proj"][t], np.eye(D))

    # cache rows of seen ids equal the oracle's trained compact rows (in
    # the first d_t columns) and the pad columns stayed EXACTLY zero
    seen = [set() for _ in range(3)]
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        for t in range(3):
            seen[t].update(batch.ls_i[t].tolist())
    cache = local_shard(tr.cache)
    for t in range(3):
        ids = np.array(sorted(seen[t]), dtype=np.int64)
        sets_t = int(tr.geo.sets[t])
        occ = tr.controller.occupancy[t]
        set_idx = ids % sets_t
        eq = occ[set_idx] == ids[:, None]
        assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
        way = eq.argmax(axis=1)
        slots = tr.geo.table_offsets[t] + way * sets_t + set_idx
        np.testing.assert_allclose(
            cache[slots][:, : dims[t]], np.asarray(W[t])[ids],
            rtol=2e-4, atol=1e-6,
        )
        np.testing.assert_array_equal(cache[slots][:, dims[t]:], 0.0)
    tr.close()


def test_cached_md_under_pressure_and_checkpoint(tmp_path):
    """Cached MD with a small cache: evictions write COMPACT rows back
    through the padded wire; dirty checkpoints restore bit-exactly; eval
    runs through the projection."""
    ln_emb = np.array([500, 200, 1000])
    cfg = make_cfg(cache_size=32, num_ways=2, md_flag=True,
                   md_temperature=1.0, lookahead=4)
    cfg.finalize(ln_emb=ln_emb)
    assert any(d < cfg.m_spa for d in cfg.m_spa_per_table)
    ds = LearnableDataset(ln_emb, num_batches=60)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=30, log_fn=lambda s: None)
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    assert 0.0 <= acc <= 1.0
    ck = str(tmp_path / "ckpt")
    tr.save_checkpoint(ck)
    assert tr.eviction_manager.rows_written > 0
    snap = [t.copy() for t in tr.master.tables]
    # masters stayed compact
    for t, d_t in enumerate(cfg.m_spa_per_table):
        assert tr.master.tables[t].shape[1] == d_t
    tr.close()

    cfg2 = make_cfg(cache_size=32, num_ways=2, md_flag=True,
                    md_temperature=1.0, lookahead=4)
    cfg2.finalize(ln_emb=ln_emb)
    tr2 = CachedDlrmTrainer(cfg2, ds, ds)
    tr2.load_checkpoint(ck)
    for a, b in zip(tr2.master.tables, snap):
        np.testing.assert_array_equal(a, b)
    tr2.train(max_steps=40, log_fn=lambda s: None)
    tr2.close()


def test_qr_with_cache_raises():
    """QR + cached path: clear error (QR tables are small by construction;
    the reference would crash in its prefetcher, model_no_ddp.py:80-87)."""
    cfg = make_cfg(qr_flag=True, qr_collisions=4)
    ds = LearnableDataset(cfg.ln_emb, num_batches=4)
    with pytest.raises(ValueError, match="qr_flag with the cached path"):
        CachedDlrmTrainer(cfg, ds)


def test_refill_delta_matches_strict():
    """refill_broadcast='delta' (evicted-row broadcast only, no O(R*D)
    whole-cache psum) must be trajectory-equal to 'strict' when
    table_agg_freq divides lookahead: every refill is then immediately
    preceded by an aggregation, so replicas are already bit-identical and
    the strict broadcast is a no-op. Same frozen-master setup as
    test_dedup_matches_plain_path (async writeback landing is
    timing-dependent by design)."""
    ln_emb = np.array([60, 30, 90])

    def run(mode):
        cfg = make_cfg(
            world_size=4, cache_size=32, num_ways=4, lookahead=4,
            table_agg_freq=2, refill_broadcast=mode, eviction_fifo_size=64,
        )
        cfg.finalize(ln_emb=ln_emb)
        ds = LearnableDataset(ln_emb, num_batches=26, batch=64, seed=6)
        tr = CachedDlrmTrainer(cfg, ds, mesh=None)
        tr.eviction_manager.start = lambda: None  # freeze master
        tr.train(max_steps=24, log_fn=lambda s: None)
        out = (
            np.asarray(tr.cache).copy(),
            {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
             for k, v in tr.params.items()},
            tr.metrics.loss_sum,
        )
        tr.close()
        return out

    cache_s, params_s, loss_s = run("strict")
    cache_d, params_d, loss_d = run("delta")
    np.testing.assert_allclose(loss_d, loss_s, rtol=1e-6)
    np.testing.assert_allclose(cache_d, cache_s, rtol=1e-6, atol=1e-7)
    for k in ("bot", "top"):
        for (w, b), (wo, bo) in zip(params_d[k], params_s[k]):
            np.testing.assert_allclose(w, wo, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b, bo, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pooled,dedup", [
    (False, False), (True, False), (False, True),
])
def test_scan_block_matches_single_step(pooled, dedup):
    """scan_steps=K (one lax.scan dispatch per K steps) must be
    step-for-step identical to single-step execution — including the agg
    cadence firing at the same global steps (blocks are capped at cadence
    boundaries) and per-step metrics. Frozen-master setup as in
    test_dedup_matches_plain_path."""
    ln_emb = np.array([50, 20, 70])

    class DupHeavyDataset:
        m_den = 13

        def __init__(self, num_batches=26, batch=32, seed=4):
            self.ln_emb = ln_emb
            self.num_batches, self.batch, self.seed = num_batches, batch, seed

        def __len__(self):
            return self.num_batches

        def batches(self):
            rng = np.random.default_rng(self.seed)
            for _ in range(self.num_batches):
                x = rng.random((self.batch, self.m_den)).astype(np.float32)
                y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
                if pooled:
                    p = 3
                    ls = np.stack(
                        [rng.integers(0, n, (self.batch, p)) for n in ln_emb]
                    )
                    mask = rng.random((3, self.batch, p)) < 0.7
                    mask[:, :, 0] = True
                    yield Batch(x, ls, mask, y)
                else:
                    ls = np.stack(
                        [rng.integers(0, n, self.batch) for n in ln_emb]
                    )
                    yield Batch(x, ls, None, y)

    def run(scan):
        cfg = make_cfg(
            mini_batch_size=32, world_size=4, cache_size=32, num_ways=4,
            lookahead=6, table_agg_freq=3, scan_steps=scan,
            eviction_fifo_size=64, print_freq=5, dedup_lookups=dedup,
        )
        cfg.finalize(ln_emb=ln_emb)
        tr = CachedDlrmTrainer(cfg, DupHeavyDataset(), mesh=None)
        tr.eviction_manager.start = lambda: None  # freeze master
        assert tr._scan_block == scan
        tr.train(max_steps=22, log_fn=lambda s: None)
        out = (
            np.asarray(tr.cache).copy(),
            {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
             for k, v in tr.params.items()},
            tr.metrics.loss_sum,
            tr.metrics.hits,
            tr.metrics.lookups,
            tr.global_step,
            tr._cursor,
        )
        tr.close()
        return out

    base = run(1)
    scanned = run(4)  # 4 does not divide lookahead 6 or agg 3: remainders
    assert base[5] == scanned[5] == 22
    assert base[6] == scanned[6]
    assert (base[3], base[4]) == (scanned[3], scanned[4])
    np.testing.assert_allclose(scanned[2], base[2], rtol=1e-5)
    np.testing.assert_allclose(scanned[0], base[0], rtol=1e-5, atol=1e-7)
    for k in ("bot", "top"):
        for (w, bb), (wo, bo) in zip(scanned[1][k], base[1][k]):
            np.testing.assert_allclose(w, wo, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(bb, bo, rtol=1e-5, atol=1e-7)


def test_wire_x_fp8_trains():
    """fp8 dense-feature wire (Config.wire_x_fp8): the step upcasts at entry
    and the learnable signal still trains; eval runs through the same wire."""
    cfg = make_cfg(wire_x_fp8=True)
    ds = LearnableDataset(cfg.ln_emb, num_batches=60)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=20, log_fn=lambda s: None)
    early = tr.metrics.loss_sum / tr.metrics.examples
    tr.metrics.loss_sum = tr.metrics.correct = 0.0
    tr.metrics.examples = tr.metrics.steps = 0
    m = tr.train(max_steps=60, log_fn=lambda s: None)
    acc, _ = tr.evaluate(log_fn=lambda s: None)
    tr.close()
    assert m.loss_sum / m.examples < early  # learnable signal survives fp8
    assert 0.0 <= acc <= 1.0


def test_resume_at_epoch_end_midwindow(tmp_path):
    """Checkpoint landing exactly at an epoch's end, mid-window (13 batches,
    lookahead 5): the resumed epoch has no remaining batches, but the
    prefetcher still re-produces the cursor's window — the pipeline must
    consume it (WINDOW_REPLAY) or every later window is off by one (review
    finding, round 2). Resumed run must equal the uninterrupted 2-epoch
    run."""
    ln_emb = np.array([40, 25, 60])
    b = 16

    def cfg_fn():
        cfg = make_cfg(
            mini_batch_size=b, world_size=4, cache_size=64, num_ways=2,
            lookahead=5, table_agg_freq=4, nepochs=2,
        )
        cfg.finalize(ln_emb=ln_emb)
        return cfg

    def ds_fn():
        return SyntheticDataset(
            m_den=13, ln_emb=ln_emb, data_size=b * 13, mini_batch_size=b,
            num_indices_per_lookup=1, num_indices_per_lookup_fixed=True,
            round_targets=True, seed=17,
        )

    tr = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr.train(max_steps=26, log_fn=lambda s: None)
    assert tr.global_step == 26  # both epochs fully consumed
    cache_ref = np.asarray(tr.cache).copy()
    occ_ref = [o.copy() for o in tr.controller.occupancy]
    tr.close()

    tr1 = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr1.train(max_steps=13, log_fn=lambda s: None)
    assert tr1._cursor == (0, 13)  # exact epoch end, mid-window (13 % 5 != 0)
    ck = str(tmp_path / "epoch_end")
    tr1.save_checkpoint(ck)
    tr1.close()

    tr2 = CachedDlrmTrainer(cfg_fn(), ds_fn())
    tr2.load_checkpoint(ck)
    tr2.train(max_steps=26, log_fn=lambda s: None)
    assert tr2.global_step == 26
    tr2.close()

    for a, bb in zip(tr2.controller.occupancy, occ_ref):
        np.testing.assert_array_equal(a, bb)
    np.testing.assert_allclose(np.asarray(tr2.cache), cache_ref, rtol=1e-6,
                               atol=1e-7)


def test_delta_with_nondividing_agg_freq_falls_back_to_strict():
    """delta's trajectory-equality precondition is table_agg_freq | lookahead
    (train/step.py make_refill_step); finalize must fall back to 'strict'
    with a warning, not train a silently different algorithm (round-2
    advisor finding)."""
    with pytest.warns(UserWarning, match="falling back to 'strict'"):
        cfg = make_cfg(refill_broadcast="delta", table_agg_freq=3, lookahead=4)
    assert cfg.refill_broadcast == "strict"
    # dividing freq keeps delta
    cfg = make_cfg(refill_broadcast="delta", table_agg_freq=2, lookahead=4)
    assert cfg.refill_broadcast == "delta"


def test_checkpoint_format_version_guard(tmp_path):
    """An incompatible checkpoint format must fail with a clear ValueError
    read from meta.pkl, not an incidental FileNotFoundError mid-restore
    (round-2 advisor finding)."""
    import pickle

    from cdlrm_tpu.train.trainer import CHECKPOINT_FORMAT_VERSION

    cfg = make_cfg()
    ds = LearnableDataset(cfg.ln_emb, num_batches=12)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=4, log_fn=lambda s: None)
    ck = str(tmp_path / "ckpt")
    tr.save_checkpoint(ck)
    tr.close()

    with open(f"{ck}/meta.pkl", "rb") as f:
        meta = pickle.load(f)
    assert meta["format_version"] == CHECKPOINT_FORMAT_VERSION
    meta["format_version"] = 1
    with open(f"{ck}/meta.pkl", "wb") as f:
        pickle.dump(meta, f)
    tr2 = CachedDlrmTrainer(make_cfg(), ds, ds)
    with pytest.raises(ValueError, match="incompatible checkpoint format"):
        tr2.load_checkpoint(ck)
    tr2.close()


class SkewSwitchDataset:
    """Windows 0-1: zipf-like duplicate-heavy stream (a handful of hot ids);
    windows 2-3: all-distinct ids. Exercises the per-window auto-dedup
    decision (config.dedup_lookups='auto')."""

    m_den = 13

    def __init__(self, ln_emb, lookahead=4, batch=64, seed=0):
        self.ln_emb = np.asarray(ln_emb)
        self.lookahead = lookahead
        self.batch = batch
        self.seed = seed
        self.num_batches = 4 * lookahead

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        for j in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
            if j < 2 * self.lookahead:  # duplicate-heavy
                ls = np.stack(
                    [rng.integers(0, 4, self.batch) for _ in self.ln_emb]
                )
            else:  # near-unique: a random permutation slice per table
                ls = np.stack(
                    [rng.permutation(n)[: self.batch] for n in self.ln_emb]
                )
            yield Batch(x, ls, None, y)


def test_auto_dedup_follows_window_duplication():
    """dedup_lookups='auto' (the default) must enable the dedup wire for
    duplicate-heavy windows (the same-index scatter-chain guard) and
    disable it for near-unique windows — decided per window from the shadow
    stats, with the trajectory matching the pinned-wire runs (the two wire
    formats are numerically equivalent, test_dedup_matches_plain_path)."""
    ln_emb = np.array([300, 400, 500])

    def run(mode, probes=False):
        cfg = make_cfg(
            mini_batch_size=64, world_size=4, cache_size=128, num_ways=4,
            lookahead=4, table_agg_freq=4, dedup_lookups=mode,
            eviction_fifo_size=64,
        )
        cfg.finalize(ln_emb=ln_emb)
        ds = SkewSwitchDataset(ln_emb, lookahead=4)
        tr = CachedDlrmTrainer(cfg, ds)
        tr.eviction_manager.start = lambda: None  # freeze master
        flags = []
        if probes:
            tr.train(max_steps=4, log_fn=lambda s: None)
            flags.append(tr._dedup)  # window 0 (skewed) decision
            tr.train(max_steps=16, log_fn=lambda s: None)
            flags.append(tr._dedup)  # window 3 (distinct) decision
        else:
            tr.train(max_steps=16, log_fn=lambda s: None)
        out = (
            np.asarray(tr.cache).copy(),
            {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
             for k, v in tr.params.items()},
            tr.metrics.loss_sum,
        )
        tr.close()
        return out, flags

    auto, flags = run("auto", probes=True)
    assert flags == [True, False], flags
    on, _ = run("on")
    off, _ = run("off")
    for other in (on, off):
        np.testing.assert_allclose(auto[0], other[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(auto[2], other[2], rtol=1e-5)
        for k in ("bot", "top"):
            for (w, bb), (wo, bo) in zip(auto[1][k], other[1][k]):
                np.testing.assert_allclose(w, wo, rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(bb, bo, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pooled,dedup,scan", [
    (False, "off", 1), (False, "on", 1), (True, "off", 1),
    (False, "auto", 4),
])
def test_hot_tier_matches_baseline(pooled, dedup, scan):
    """hot_tier_rows > 0 splits the sparse update into a segment-summed
    H-row hot scatter + an exactly-bucketed cold scatter. Semantics are the
    same gradient sums in a different float order — the trajectory must
    match the baseline update allclose across wire formats, pooling, and
    scan blocks, on a duplicate-heavy stream where most lookups are hot."""
    ln_emb = np.array([60, 30, 80])

    class HotHeavyDataset:
        m_den = 13

        def __init__(self, num_batches=26, batch=32, seed=7):
            self.ln_emb = ln_emb
            self.num_batches, self.batch, self.seed = num_batches, batch, seed

        def __len__(self):
            return self.num_batches

        def batches(self):
            rng = np.random.default_rng(self.seed)
            for _ in range(self.num_batches):
                x = rng.random((self.batch, self.m_den)).astype(np.float32)
                y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
                if pooled:
                    p = 3
                    # zipf-ish: half the lookups land on 4 hot ids
                    hot = rng.integers(0, 4, (self.batch, p))
                    cold = np.stack(
                        [rng.integers(0, n, (self.batch, p)) for n in ln_emb]
                    )
                    pick = rng.random((3, self.batch, p)) < 0.5
                    ls = np.where(pick, hot[None], cold)
                    mask = rng.random((3, self.batch, p)) < 0.7
                    mask[:, :, 0] = True
                    yield Batch(x, ls, mask, y)
                else:
                    hot = rng.integers(0, 4, self.batch)
                    cold = np.stack(
                        [rng.integers(0, n, self.batch) for n in ln_emb]
                    )
                    pick = rng.random((3, self.batch)) < 0.5
                    ls = np.where(pick, hot[None], cold)
                    yield Batch(x, ls, None, y)

    def run(hot_rows):
        cfg = make_cfg(
            mini_batch_size=32, world_size=4, cache_size=32, num_ways=4,
            lookahead=5, table_agg_freq=3, scan_steps=scan,
            dedup_lookups=dedup, hot_tier_rows=hot_rows,
            eviction_fifo_size=64,
        )
        cfg.finalize(ln_emb=ln_emb)
        tr = CachedDlrmTrainer(cfg, HotHeavyDataset())
        tr.eviction_manager.start = lambda: None  # freeze master
        tr.train(max_steps=22, log_fn=lambda s: None)
        out = (
            np.asarray(tr.cache).copy(),
            {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
             for k, v in tr.params.items()},
            tr.metrics.loss_sum,
            tr.metrics.hits,
            tr.global_step,
        )
        tr.close()
        return out

    base = run(0)
    hot = run(16)
    assert base[4] == hot[4] == 22
    assert base[3] == hot[3]
    np.testing.assert_allclose(hot[2], base[2], rtol=1e-5)
    np.testing.assert_allclose(hot[0], base[0], rtol=1e-4, atol=1e-6)
    for k in ("bot", "top"):
        for (w, bb), (wo, bo) in zip(hot[1][k], base[1][k]):
            np.testing.assert_allclose(w, wo, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(bb, bo, rtol=1e-5, atol=1e-6)


def test_hot_tier_single_replica_scan():
    """world_size=1 (track_touched=False: no touched carry) + scan blocks +
    hot tier — the headline-bench shape; pins the carry structure bug where
    the hot update returned None for the untracked touched mask."""
    cfg = make_cfg(
        mini_batch_size=32, world_size=1, cache_size=64, num_ways=4,
        lookahead=6, table_agg_freq=1000, scan_steps=3, hot_tier_rows=16,
        dedup_lookups="auto",
    )
    ds = LearnableDataset(cfg.ln_emb, num_batches=20, batch=32)
    tr = CachedDlrmTrainer(cfg, ds)
    m = tr.train(max_steps=18, log_fn=lambda s: None)
    tr.close()
    assert tr.global_step == 18
    assert np.isfinite(m.loss_sum)


def test_eval_pipeline_depth_invariant_and_repeatable():
    """The pipelined serving path (round-4: producer thread probes/stages
    ahead, scores D2H lags one batch) must be a pure latency optimization:
    results identical across pipeline depths and across repeated calls."""
    results = []
    for depth in (1, 4):
        cfg = make_cfg(test_freq=-1, pipeline_depth=depth)
        ds = LearnableDataset(cfg.ln_emb, num_batches=30)
        test = LearnableDataset(cfg.ln_emb, num_batches=6, seed=9)
        tr = CachedDlrmTrainer(cfg, ds, test)
        tr.train(max_steps=10, log_fn=lambda s: None)
        a1 = tr.evaluate(log_fn=lambda s: None)
        a2 = tr.evaluate(log_fn=lambda s: None)
        tr.close()
        assert a1 == a2  # repeat on the same trainer: bit-identical
        results.append(a1)
    assert results[0] == results[1]  # depth changes scheduling only


def test_eval_producer_error_propagates():
    """An exception in the eval producer thread (mid-stream dataset failure)
    must surface as an exception from evaluate(), not a hang or a silently
    truncated metric."""

    class ExplodingDataset(LearnableDataset):
        def batches(self):
            for i, b in enumerate(super().batches()):
                if i == 3:
                    raise RuntimeError("disk gone")
                yield b

    cfg = make_cfg(test_freq=-1)
    ds = LearnableDataset(cfg.ln_emb, num_batches=20)
    bad = ExplodingDataset(cfg.ln_emb, num_batches=8, seed=9)
    tr = CachedDlrmTrainer(cfg, ds, bad)
    tr.train(max_steps=8, log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="disk gone"):
        tr.evaluate(log_fn=lambda s: None)
    tr.close()


@pytest.mark.parametrize("trainer_kind", ["cached", "fulltable"])
def test_adagrad_equals_hand_oracle_when_fully_resident(trainer_kind):
    """optimizer='adagrad' (beyond-parity; the reference is SGD-only,
    main_no_ddp.py:374-376): both the cached path (row-wise state riding
    the dedup wire, train/step.py body_dedup) and the full-table path must
    reproduce a LONGHAND AdaGrad oracle exactly when fully resident —
    element-wise torch-semantics AdaGrad on the dense MLPs, row-wise
    (torchrec semantics) on embedding rows. Pins the state gather/scatter,
    refill reset plumbing (no evictions here), and the scan carry."""
    import jax
    import jax.numpy as jnp

    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward
    from cdlrm_tpu.parallel.mesh import make_dp_mesh
    from cdlrm_tpu.train import step as step_lib

    ln_emb = np.array([40, 25, 60])
    steps, b, eps = 12, 16, 1e-10
    cfg = make_cfg(
        mini_batch_size=b, world_size=1, cache_size=64, num_ways=2,
        lookahead=3, table_agg_freq=10_000, learning_rate=0.1, lr_embeds=0.3,
        optimizer="adagrad", dedup_lookups="on",
        use_cache=(trainer_kind == "cached"),
    )
    cfg.finalize(ln_emb=ln_emb)
    ds = LearnableDataset(ln_emb, num_batches=steps + 2, batch=b, seed=3)
    mesh = make_dp_mesh(1)
    if trainer_kind == "cached":
        assert all(int(n) <= cfg.cache_sets for n in ln_emb)
        tr = CachedDlrmTrainer(cfg, ds, mesh=mesh)
        tables = [jnp.asarray(tr.master.tables[t].copy()) for t in range(3)]
    else:
        from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer

        tr = FullTableDlrmTrainer(cfg, ds, mesh=mesh)
        tables = [jnp.asarray(np.asarray(w).copy())
                  for w in step_lib.unreplicate(tr.params)["emb"]]

    p0 = step_lib.unreplicate(tr.params)
    params_o = {k: [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in v]
                for k, v in p0.items() if k in ("bot", "top")}

    tr.train(max_steps=steps, log_fn=lambda s: None)

    acc_p = {k: [(jnp.zeros_like(w), jnp.zeros_like(bb))
                 for w, bb in v] for k, v in params_o.items()}
    acc_t = [jnp.zeros(t.shape[0]) for t in tables]
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        x, tgt = jnp.asarray(batch.x), jnp.asarray(batch.y)
        ls = batch.ls_i

        def loss_fn(params, tables):
            ly = jnp.stack([tables[t][ls[t]] for t in range(3)])
            p = dlrm_forward(params, x, ly, "dot", False, 0.0)
            return compute_loss(p, tgt, cfg.loss_function)

        g_p, g_t = jax.grad(loss_fn, argnums=(0, 1))(params_o, tables)
        # element-wise AdaGrad, torch semantics (eps OUTSIDE the sqrt)
        new_p, new_a = {}, {}
        for k, v in params_o.items():
            new_p[k], new_a[k] = [], []
            for (w, bb), (gw, gb), (aw, ab) in zip(v, g_p[k], acc_p[k]):
                aw, ab = aw + gw * gw, ab + gb * gb
                new_p[k].append((w - 0.1 * gw / (jnp.sqrt(aw) + eps),
                                 bb - 0.1 * gb / (jnp.sqrt(ab) + eps)))
                new_a[k].append((aw, ab))
        params_o, acc_p = new_p, new_a
        # row-wise AdaGrad (torchrec semantics: state += mean(g^2) per row)
        new_t, new_at = [], []
        for t, gt, at in zip(tables, g_t, acc_t):
            at = at + jnp.mean(gt * gt, axis=1)
            new_t.append(t - 0.3 * gt / (jnp.sqrt(at) + eps)[:, None])
            new_at.append(at)
        tables, acc_t = new_t, new_at

    got_p = step_lib.unreplicate(tr.params)
    for k in ("bot", "top"):
        for (w, bb), (wo, bo) in zip(got_p[k], params_o[k]):
            np.testing.assert_allclose(w, wo, rtol=2e-4, atol=1e-6)
            np.testing.assert_allclose(bb, bo, rtol=2e-4, atol=1e-6)

    if trainer_kind == "fulltable":
        got_t = step_lib.unreplicate(tr.params)["emb"]
        for t in range(3):
            np.testing.assert_allclose(
                got_t[t], tables[t], rtol=2e-4, atol=1e-6)
        got_acc = step_lib.unreplicate(tr.accum)["emb"]
        for t in range(3):
            np.testing.assert_allclose(
                got_acc[t], acc_t[t], rtol=2e-4, atol=1e-6)
        return

    # cached: every seen id's cache row AND row-wise accumulator must match
    from cdlrm_tpu.parallel.mesh import local_shard

    seen = [set() for _ in range(3)]
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        for t in range(3):
            seen[t].update(batch.ls_i[t].tolist())
    cache = local_shard(tr.cache)
    eacc = local_shard(tr.embed_acc)
    for t in range(3):
        ids = np.array(sorted(seen[t]), dtype=np.int64)
        sets_t = int(tr.geo.sets[t])
        occ = tr.controller.occupancy[t]
        set_idx = ids % sets_t
        eq = occ[set_idx] == ids[:, None]
        assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
        way = eq.argmax(axis=1)
        slots = tr.geo.table_offsets[t] + way * sets_t + set_idx
        np.testing.assert_allclose(
            cache[slots], np.asarray(tables[t])[ids], rtol=2e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            eacc[slots], np.asarray(acc_t[t])[ids], rtol=2e-4, atol=1e-6
        )


def test_adagrad_config_guards():
    ln = np.array([50, 20, 70])

    def raw(**kw):
        return Config(arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
                      arch_mlp_top="8-1", mini_batch_size=64, world_size=8,
                      cache_size=64, num_ways=4, **kw)

    with pytest.raises(ValueError, match="dedup_lookups"):
        raw(optimizer="adagrad").finalize(ln_emb=ln)  # default dedup 'auto'
    with pytest.raises(ValueError, match="hot tier"):
        raw(optimizer="adagrad", dedup_lookups="on",
            hot_tier_rows=8).finalize(ln_emb=ln)
    with pytest.raises(ValueError, match="optimizer"):
        raw(optimizer="rmsprop").finalize(ln_emb=ln)
    with pytest.raises(ValueError, match="plain embeddings"):
        raw(optimizer="adagrad", dedup_lookups="on", qr_flag=True,
            qr_threshold=10).finalize(ln_emb=ln)
    # fulltable adagrad needs no dedup wire (no cache probe at all)
    raw(optimizer="adagrad", use_cache=False).finalize(ln_emb=ln)


def test_inference_only_loads_adagrad_checkpoint(tmp_path):
    """Serving (--inference-only) never reads optimizer state, so an
    adagrad-trained checkpoint must load under the default SGD config when
    inference_only is set — and still be refused for TRAINING resume."""
    ln = np.array([500, 200, 1000])
    cfg = make_cfg(optimizer="adagrad", dedup_lookups="on")
    ds = LearnableDataset(ln, num_batches=20)
    tr = CachedDlrmTrainer(cfg, ds, ds)
    tr.train(max_steps=8, log_fn=lambda s: None)
    ck = str(tmp_path / "ag")
    tr.save_checkpoint(ck)
    tr.close()

    with pytest.raises(ValueError, match="AdaGrad optimizer state"):
        t2 = CachedDlrmTrainer(make_cfg(), ds, ds)
        try:
            t2.load_checkpoint(ck)
        finally:
            t2.close()

    t3 = CachedDlrmTrainer(make_cfg(inference_only=True), ds, ds)
    t3.load_checkpoint(ck)
    acc, auc = t3.evaluate(log_fn=lambda s: None)
    t3.close()
    assert 0.0 <= acc <= 1.0


def test_async_checkpoint_matches_sync(tmp_path):
    """--checkpoint-async: the write phase runs on a background thread over
    a consistent snapshot (dirty-master rows fancy-index-copied before new
    writebacks land). Training CONTINUES during the write; the files must
    equal a synchronous save taken at the same step of an identical run."""
    ln = np.array([500, 200, 1000])

    def run(async_mode):
        cfg = make_cfg(checkpoint_async=async_mode)
        ds = LearnableDataset(ln, num_batches=60)
        tr = CachedDlrmTrainer(cfg, ds, ds)
        tr.train(max_steps=24, log_fn=lambda s: None)
        ck = str(tmp_path / ("async" if async_mode else "sync"))
        tr.save_checkpoint(ck)
        if async_mode:
            assert tr._ckpt_thread is not None
            # keep training while the writer serializes — new writebacks
            # must not leak into the snapshot
            tr.train(max_steps=48, log_fn=lambda s: None)
        tr.close()  # joins the writer
        return ck

    ck_s = run(False)
    ck_a = run(True)
    import os
    for name in sorted(os.listdir(ck_s)):
        if name == "meta.pkl":
            # identical runs pickle identical meta (rng state may hold
            # arrays, so compare serialized bytes)
            with open(os.path.join(ck_s, name), "rb") as f:
                ms = f.read()
            with open(os.path.join(ck_a, name), "rb") as f:
                ma = f.read()
            assert ms == ma
            continue
        # .npy loads return arrays, .npz return archives — handle both
        a_s = np.load(os.path.join(ck_s, name), allow_pickle=False)
        a_a = np.load(os.path.join(ck_a, name), allow_pickle=False)
        if name.endswith(".npz"):
            assert sorted(a_s.files) == sorted(a_a.files), name
            for k in a_s.files:
                np.testing.assert_array_equal(a_s[k], a_a[k], err_msg=f"{name}:{k}")
            a_s.close(); a_a.close()
        else:
            np.testing.assert_array_equal(a_s, a_a, err_msg=name)

    # and the async checkpoint restores into a working trainer
    tr = CachedDlrmTrainer(make_cfg(), LearnableDataset(ln, num_batches=60),
                           LearnableDataset(ln, num_batches=4, seed=9))
    tr.load_checkpoint(ck_a)
    assert tr.global_step == 24
    tr.train(max_steps=30, log_fn=lambda s: None)
    tr.close()


def test_refill_prestage_matches_unstaged():
    """config.refill_prestage (default): the _WindowStager pre-joins each
    shadow-planned window's insert plan and starts the padded H2D during the
    previous window's compute.

    Exactness envelope: plan METADATA (insert/evict slots, occupancy, RNG —
    all shadow-planned, timing-independent) must be BIT-identical to the
    synchronous boundary path, and with no writebacks in flight the whole
    trajectory must be bit-identical too. Inserted row VALUES may read
    either side of an in-flight eviction writeback (the reference's
    eventually-consistent cache-manager semantics, cache_manager.py:48-64 —
    a pre-existing envelope the stager only re-times), so under heavy
    eviction the trajectories must agree to tolerance, not bitwise."""
    ln = np.array([500, 200, 1000])

    def run(prestage, **cfg_kw):
        cfg = make_cfg(refill_prestage=prestage, **cfg_kw)
        ds = LearnableDataset(ln, num_batches=60)
        tr = CachedDlrmTrainer(cfg, ds, ds)
        tr.train(max_steps=48, log_fn=lambda s: None)
        if prestage:
            assert tr._stager is not None and tr._stager.is_alive()
        else:
            assert tr._stager is None
        import jax
        from cdlrm_tpu.train import step as step_lib
        leaves, _ = jax.tree_util.tree_flatten(
            step_lib.unreplicate(tr.params))
        out = (
            [np.asarray(l) for l in leaves],
            np.concatenate([np.asarray(s.data)
                            for s in tr.cache.addressable_shards]),
            float(tr.metrics.loss_sum),
            int(tr.eviction_manager.rows_written),
            tr.metrics.refills,
            {k: np.copy(v) for k, v in tr.controller.state_dict().items()},
        )
        tr.close()
        return out

    # heavy-eviction regime: metadata bitwise, values to tolerance
    p_on, c_on, loss_on, wb_on, rf_on, occ_on = run(True)
    p_off, c_off, loss_off, wb_off, rf_off, occ_off = run(False)
    assert rf_on == rf_off and rf_on > 1  # refills actually happened
    assert wb_on == wb_off and wb_on > 0  # eviction writebacks live
    assert sorted(occ_on) == sorted(occ_off)
    for k in occ_on:
        np.testing.assert_array_equal(occ_on[k], occ_off[k], err_msg=k)
    assert loss_on == pytest.approx(loss_off, rel=1e-5)
    for a, b in zip(p_on, p_off):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    # no-eviction regime: masters never mutate -> BIT-identical end to end
    big = dict(cache_size=1024, num_ways=8)
    p_on, c_on, loss_on, wb_on, rf_on, _ = run(True, **big)
    p_off, c_off, loss_off, wb_off, rf_off, _ = run(False, **big)
    assert rf_on == rf_off and rf_on > 1
    assert wb_on == wb_off == 0
    assert loss_on == loss_off
    for a, b in zip(p_on, p_off):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c_on, c_off)


def test_adagrad_hot_lr_warns():
    """AdaGrad at SGD-scale lrs measured as sigmoid saturation (AUC 0.5 on
    a mid-scale synthetic task) — finalize warns; AdaGrad-scale lrs
    stay silent."""
    import warnings

    with pytest.warns(UserWarning, match="sign-sized"):
        make_cfg(optimizer="adagrad", lr_embeds=0.5,
                 dedup_lookups="on")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_cfg(optimizer="adagrad", learning_rate=0.01, lr_embeds=0.05,
                 dedup_lookups="on")


@pytest.mark.parametrize("prestage", [True, False])
def test_close_mid_stream_joins_pipeline_threads(prestage):
    """close() after a partial run — the prefetcher still ahead of the
    trainer — must leave no pipeline thread alive: a daemon thread caught
    inside native code at interpreter exit aborts the process. Queued
    writebacks land before close() returns."""
    ln = np.array([500, 200, 1000])
    cfg = make_cfg(world_size=2, lookahead=2, batch_fifo_size=2,
                   refill_prestage=prestage)
    cfg.finalize(ln_emb=ln)
    tr = CachedDlrmTrainer(cfg, LearnableDataset(ln, num_batches=40))
    tr.train(max_steps=6, log_fn=lambda s: None)
    threads = [tr.prefetcher, tr._pipe, tr._stager, tr.eviction_manager]
    tr.close()
    alive = [t.name for t in threads if t is not None and t.is_alive()]
    assert not alive, alive
    assert tr.eviction_fifo.empty()
