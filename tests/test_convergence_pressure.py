"""Convergence under cache PRESSURE: the offline proxy for the standing
real-Criteo AUC-parity obligation (BASELINE.md).

The paper's core claim is that lookahead caching does not hurt training.
Round 2 validated it only in the fully-resident regime (where caching does
nothing interesting); this study sizes the cache to ~10% / ~30% / >=100% of
the id space on a Zipf-skewed stream whose TARGET IS CARRIED BY THE
EMBEDDINGS (per-id latent values), so misses, evictions, and writebacks all
actively shape the trajectory — then compares final accuracy/AUC against the
cache-free full-table oracle. Reference anchor for the eventually-consistent
writeback semantics being stressed: /root/reference/cache_manager.py:48-64.

Measured envelope (8-device CPU mesh, 600 steps, recorded in PERF.md —
re-derived here as assertions with slack):
  - >=100% capacity: cached match the oracle closely (near-zero miss path);
  - 30% capacity: small degradation (<= ~0.05 acc / AUC);
  - 10% capacity: visible but bounded degradation (<= ~0.10 acc / AUC), and
    the loss still falls well below the untrained baseline;
  - average_on_writeback on/off both converge at 30%.
"""

import numpy as np
import pytest

from cdlrm_tpu.config import Config
from cdlrm_tpu.data.synthetic import Batch
from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu.train.trainer import CachedDlrmTrainer

N_IDS = 2000
TABLES = 3
STEPS = 600
BATCH = 64


class LatentSignalDataset:
    """Zipf-skewed stream whose label is a deterministic function of hidden
    per-id latents: y = 1[ sum_t v_t[id_t] > 0 ]. The model can only learn
    by training embedding rows, so cache staleness/misses directly affect
    convergence (unlike dense-feature targets, which bypass the cache)."""

    m_den = 13

    def __init__(self, num_batches, seed=0, label_seed=99):
        self.ln_emb = np.full(TABLES, N_IDS, dtype=np.int64)
        self.num_batches = num_batches
        self.seed = seed
        lrng = np.random.default_rng(label_seed)
        self.latents = lrng.normal(size=(TABLES, N_IDS)).astype(np.float32)

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            x = rng.random((BATCH, self.m_den)).astype(np.float32)
            # zipf-ish head concentration via inverse-CDF log-uniform
            u = rng.random((TABLES, BATCH))
            ls = (np.exp(u * np.log(N_IDS)).astype(np.int64) - 1) % N_IDS
            v = self.latents[np.arange(TABLES)[:, None], ls].sum(axis=0)
            y = (v > 0).astype(np.float32)[:, None]
            yield Batch(x, ls, None, y)


def _cfg(**kw):
    base = dict(
        arch_sparse_feature_size=8,
        arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1",
        mini_batch_size=BATCH,
        world_size=8,
        loss_function="bce",
        lookahead=8,
        table_agg_freq=8,
        print_freq=100,
        learning_rate=0.1,
        lr_embeds=0.5,
        num_ways=2,
        eviction_fifo_size=256,
    )
    base.update(kw)
    cfg = Config(**base)
    cfg.finalize(ln_emb=np.full(TABLES, N_IDS, dtype=np.int64))
    return cfg


def _run_cached(capacity_frac, average_on_writeback=False):
    # capacity = sets * ways rows per table; next_prime keeps sets >= ask
    sets = max(8, int(N_IDS * capacity_frac) // 2)
    cfg = _cfg(
        cache_size=sets, num_ways=2,
        average_on_writeback=average_on_writeback,
    )
    train = LatentSignalDataset(STEPS + 4)
    test = LatentSignalDataset(6, seed=1234)
    tr = CachedDlrmTrainer(cfg, train, test)
    final = {}

    def log(line):
        if tr.last_window is not None:
            final.update(tr.last_window)

    tr.train(max_steps=STEPS, log_fn=log)
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    rows_written = tr.eviction_manager.rows_written
    tr.close()
    return {
        "acc": acc, "auc": auc, "loss": final.get("loss", np.nan),
        "hit_rate": final.get("hit_rate", np.nan),
        "rows_written": rows_written,
    }


def _run_oracle():
    cfg = _cfg(use_cache=False, num_indices_per_lookup=1,
               num_indices_per_lookup_fixed=True)
    train = LatentSignalDataset(STEPS + 4)
    test = LatentSignalDataset(6, seed=1234)
    tr = FullTableDlrmTrainer(cfg, train, test)
    tr.train(max_steps=STEPS, log_fn=lambda s: None)
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    return {"acc": acc, "auc": auc}


@pytest.mark.slow
def test_convergence_under_cache_pressure():
    oracle = _run_oracle()
    full = _run_cached(1.2)
    mid = _run_cached(0.3)
    tight = _run_cached(0.1)
    mid_avg = _run_cached(0.3, average_on_writeback=True)

    print("\n[pressure] oracle:", oracle)
    for name, r in (("100%", full), ("30%", mid), ("10%", tight),
                    ("30%+avg", mid_avg)):
        print(f"[pressure] {name}:", r)

    # the oracle must itself learn the latent signal, or the study is vacuous
    assert oracle["auc"] > 0.8

    # pressure is real: misses force evictions + writebacks at 10%/30%
    assert tight["rows_written"] > 0
    assert mid["rows_written"] > 0
    assert tight["hit_rate"] < 0.995

    # the paper's claim, quantified: degradation vs the oracle stays inside
    # the measured envelope even when the cache holds a fraction of the ids
    assert full["auc"] >= oracle["auc"] - 0.02
    assert mid["auc"] >= oracle["auc"] - 0.05
    assert tight["auc"] >= oracle["auc"] - 0.10
    # averaging fresh-trained rows with stale master values at writeback
    # slows convergence a little further than overwrite
    assert mid_avg["auc"] >= oracle["auc"] - 0.07
    assert full["acc"] >= oracle["acc"] - 0.03
    assert mid["acc"] >= oracle["acc"] - 0.06
    assert tight["acc"] >= oracle["acc"] - 0.10

    # and training demonstrably happened everywhere (bce of a coin is .693)
    for r in (full, mid, tight, mid_avg):
        assert r["loss"] < 0.60
