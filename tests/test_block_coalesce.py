"""Block-coalesced sparse update (config.block_coalesced_update /
train/step.py StepConfig.block_coalesce): per-lookup gradients accumulate in
a small pending buffer in block-union row space; the cache pays ONE
union-row scatter per scan block. SGD-exact up to float reassociation
(design notes in the StepConfig docstring).

These tests pin the trainer-level equivalence against the per-step dedup
path on the 8-virtual-device CPU mesh, with the full flow live: prefetcher
windows, refills, evictions + writebacks, aux-region misses, cadence-split
remainder blocks.
"""

import numpy as np
import pytest

import jax

from cdlrm_tpu.config import Config
from cdlrm_tpu.data.synthetic import Batch, SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer

LN_EMB = np.array([600, 300, 1200])


def _cfg(coalesce: bool, **kw) -> Config:
    base = dict(
        arch_sparse_feature_size=16,
        arch_mlp_bot="13-32-16",
        arch_mlp_top="16-8-1",
        mini_batch_size=64,
        world_size=8,
        cache_size=96,
        num_ways=4,
        loss_function="bce",
        lookahead=8,
        scan_steps=4,
        table_agg_freq=8,  # default 1 caps every block at size 1
        print_freq=1 << 20,
        dedup_lookups="on",
        pack_wire=False,
        block_coalesced_update=coalesce,
        round_targets=True,
    )
    base.update(kw)
    cfg = Config(**base)
    cfg.finalize(ln_emb=LN_EMB)
    return cfg


def _run(coalesce: bool, steps: int = 24, **kw):
    cfg = _cfg(coalesce, **kw)
    ds = SyntheticDataset(
        m_den=13, ln_emb=LN_EMB, data_size=64 * 64,
        mini_batch_size=64, seed=11, round_targets=True,
    )
    tr = CachedDlrmTrainer(cfg, ds, ds)
    try:
        m = tr.train(max_steps=steps)
        if coalesce:
            # guard against a silent fallback: the coalesced step variant
            # must actually have been compiled and dispatched
            assert any(k[3] for k in tr._step_cache), (
                "block_coalesced_update set but no coalesced block ran"
            )
        cache = np.asarray(jax.device_get(tr.cache))
        params = jax.device_get(tr.params)
        # real (non-aux, non-trash) region mask in the flat row space
        geo = tr.geo
        real = np.zeros(geo.total_rows, bool)
        for t in range(len(LN_EMB)):
            off = int(geo.table_offsets[t])
            real[off: int(geo.aux_base(t))] = True
        hits = m.hit_rate
        return m.loss_sum, cache, params, real, hits
    finally:
        tr.close()


@pytest.mark.slow
def test_trainer_equivalence_vs_per_step():
    """Same stream, coalesce on vs off: identical trajectory up to float
    reassociation (w_eff = c0 - lr*(g1+g2) vs ((c0-lr*g1)-lr*g2)). The
    stream is sized so misses (aux lanes), refills and evictions all fire
    inside the compared region."""
    loss_a, cache_a, params_a, real, hits_a = _run(False)
    loss_b, cache_b, params_b, _, hits_b = _run(True)
    assert hits_a == pytest.approx(hits_b, abs=1e-12)  # probe is identical
    assert hits_a < 0.999  # the aux/miss path must actually be live
    assert loss_b == pytest.approx(loss_a, rel=2e-4)
    # per-replica cache copies: compare the REAL cache region only — the
    # aux region is write-only scratch and intentionally diverges
    # (StepConfig.block_coalesce doc)
    n = real.size
    ca = cache_a.reshape(-1, n, cache_a.shape[-1])
    cb = cache_b.reshape(-1, n, cache_b.shape[-1])
    np.testing.assert_allclose(
        cb[:, real], ca[:, real], rtol=2e-4, atol=2e-6
    )
    for la, lb in zip(jax.tree_util.tree_leaves(params_a),
                      jax.tree_util.tree_leaves(params_b)):
        np.testing.assert_allclose(
            np.asarray(lb), np.asarray(la), rtol=2e-4, atol=2e-6
        )


class _DistinctIdStream:
    """Minimal dataset stub: batch j looks up ids [j*B, (j+1)*B) mod R —
    every id appears at most once per scan block, so the coalesced flush
    must be BIT-identical to the per-step update (single-addend pending
    rows take the same float path)."""

    def __init__(self, m_den, ln_emb, n_batches, b, seed=3):
        self.m_den, self.ln_emb = m_den, np.asarray(ln_emb, np.int64)
        self.num_batches, self.b = n_batches, b

    def __len__(self):
        return self.num_batches

    def batches(self, skip: int = 0):
        t = len(self.ln_emb)
        for j in range(skip, self.num_batches):
            rng = np.random.default_rng([7, j])
            x = rng.random((self.b, self.m_den), np.float32)
            base = np.arange(j * self.b, (j + 1) * self.b, dtype=np.int64)
            ls_i = np.stack([base % int(r) for r in self.ln_emb])
            y = (rng.random((self.b, 1)) < 0.5).astype(np.float32)
            yield Batch(x, ls_i, None, y)


@pytest.mark.slow
def test_single_touch_rows_bit_exact():
    """Rows touched at most once per block take the identical float path
    (the flush IS the per-step update then): with a stream of globally
    unique ids per window, the coalesced cache is BIT-exact."""
    ln = np.array([4096])
    kw = dict(cache_size=1024, num_ways=4, lookahead=4, scan_steps=2,
              table_agg_freq=4, mini_batch_size=16)

    def run(coalesce):
        cfg = Config(
            arch_sparse_feature_size=16, arch_mlp_bot="13-32-16",
            arch_mlp_top="16-8-1", world_size=8, loss_function="bce",
            print_freq=1 << 20, dedup_lookups="on", pack_wire=False,
            block_coalesced_update=coalesce, round_targets=True, **kw)
        cfg.finalize(ln_emb=ln)
        ds = _DistinctIdStream(13, ln, n_batches=16, b=16)
        tr = CachedDlrmTrainer(cfg, ds, ds)
        try:
            tr.train(max_steps=8)
            if coalesce:
                assert any(k[3] for k in tr._step_cache)
            return np.asarray(jax.device_get(tr.cache)), tr.geo
        finally:
            tr.close()

    cache_a, geo = run(False)
    cache_b, _ = run(True)
    real = np.zeros(geo.total_rows, bool)
    real[: int(geo.aux_base(0))] = True
    n = real.size
    ca = cache_a.reshape(-1, n, cache_a.shape[-1])
    cb = cache_b.reshape(-1, n, cache_b.shape[-1])
    np.testing.assert_array_equal(cb[:, real], ca[:, real])


def test_config_guards():
    # explicit 'on' (legacy bool True) raises on every illegal combo —
    # the user asked for it and must learn why they can't have it
    with pytest.raises(ValueError, match="scan_steps"):
        _cfg(True, scan_steps=1)
    with pytest.raises(ValueError, match="unpacked dedup"):
        _cfg(True, pack_wire=True)
    with pytest.raises(ValueError, match="unpacked dedup"):
        _cfg(True, dedup_lookups="off")
    with pytest.raises(ValueError, match="sgd"):
        _cfg(True, optimizer="adagrad", learning_rate=0.01, lr_embeds=0.01)
    with pytest.raises(ValueError, match="hot_tier"):
        _cfg(True, hot_tier_rows=64)
    with pytest.raises(ValueError, match="on|off|auto"):
        _cfg("sometimes")


def test_config_auto_resolution():
    """'auto' (the default) enables the coalesced update exactly when the
    measured-GO preconditions hold and silently declines otherwise
    (auto-dedup's capability-gate pattern); finalize() resolves the field
    to a plain bool either way."""
    # the _cfg base (scan 4, unpacked dedup wire, sgd, no hot tier) is the
    # legal regime: auto resolves ON
    assert _cfg("auto").block_coalesced_update is True
    # the config DEFAULT is auto
    assert _cfg(Config.block_coalesced_update).block_coalesced_update is True
    # every illegal leg flips auto off without raising
    assert _cfg("auto", scan_steps=1).block_coalesced_update is False
    assert _cfg("auto", pack_wire=True).block_coalesced_update is False
    assert _cfg("auto", dedup_lookups="off").block_coalesced_update is False
    assert _cfg(
        "auto", optimizer="adagrad", dedup_lookups="on",
        learning_rate=0.01, lr_embeds=0.01,
    ).block_coalesced_update is False
    assert _cfg("auto", hot_tier_rows=64).block_coalesced_update is False
    # explicit off (legacy bool False) stays off in the legal regime
    assert _cfg(False).block_coalesced_update is False
    # explicit on in the legal regime resolves True
    assert _cfg("on").block_coalesced_update is True
