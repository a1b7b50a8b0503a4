"""Convergence under cache pressure at BENCH GEOMETRY, on the GPU: the toy
pressure study
(tests/test_convergence_pressure.py, 3 tables x 2000 ids, dim 8, CPU mesh)
validates the paper's "caching doesn't hurt" claim only at toy dynamics;
this script runs the same latent-embedding-target design at the paper-repro
geometry — 26 tables x 250k ids, dim 128, batch 4096, bf16 compute, prime
sets, multi-window staleness — with a FULL-TABLE HBM oracle (26x250k x128
f32 ~ 3.3 GB, fits in one card's memory) against cached runs at ~30% and ~10% effective
capacity, evictions + writebacks live.

Reference anchor for the writeback semantics under stress:
/root/reference/cache_manager.py:48-64 (eventually-consistent eviction
writeback into the shared master tables).

Prints one JSON line with the AUC envelope (`pressure_auc_gap` per
capacity point) and asserts the pressure was real (hit rate < 0.99 at 10%,
rows written back > 0).
"""

import json
import os
import sys
import time

import numpy as np

# Geometry is env-overridable so the script can be smoke-tested on the CPU
# mesh (tiny shapes) before burning a chip run; defaults are the bench
# geometry the artifact requires.
TABLES = int(os.environ.get("PRESSURE_TABLES", "26"))
N_IDS = int(os.environ.get("PRESSURE_IDS", "250000"))
DIM = int(os.environ.get("PRESSURE_DIM", "128"))
BATCH = int(os.environ.get("PRESSURE_BATCH", "4096"))
STEPS = int(os.environ.get("PRESSURE_STEPS", "240"))
# eval stream size (AUC noise scales 1/sqrt(batches*BATCH); the CPU
# mid-scale study needs more batches at its smaller BATCH)
EVAL_BATCHES = int(os.environ.get("PRESSURE_EVAL_BATCHES", "4"))
STREAM = os.environ.get("PRESSURE_STREAM", "loguniform")
# PRESSURE_HETERO=1: geometric table-size spread (N/10 .. N) instead of
# uniform N — the shape MD compression exists for; PRESSURE_MD=1 turns on
# cached mixed-dimension training (the round-4 beyond-parity path)
HETERO = os.environ.get("PRESSURE_HETERO", "0") == "1"
MD = os.environ.get("PRESSURE_MD", "0") == "1"
SIZES = (
    np.geomspace(max(1000, N_IDS // 10), N_IDS, TABLES).astype(np.int64)
    if HETERO else np.full(TABLES, N_IDS, dtype=np.int64)
)
# the paper's central design parameter: long lookahead amortizes refill
# cost but lengthens the window a cached row goes without master sync —
# sweepable so the staleness axis of the AUC envelope is measurable
LOOKAHEAD = int(os.environ.get("PRESSURE_LOOKAHEAD", "8"))
# associativity axis: sets scale as capacity/ways, so a ways sweep at fixed
# PRESSURE_CAPS is iso-capacity — it isolates conflict-miss dynamics
# (fewer ways = more same-set collisions among concurrently-hot ids)
WAYS = int(os.environ.get("PRESSURE_WAYS", "8"))


def log(msg):
    print(f"[pressure] {msg}", file=sys.stderr, flush=True)


class LatentSignalDataset:
    """Skewed stream whose label is carried by hidden per-id latents:
    y = 1[ sum_t v_t[id_t] > 0 ]. The model can only learn by training
    embedding rows, so misses/evictions/writebacks directly shape the
    trajectory (tests/test_convergence_pressure.py design, scaled up)."""

    m_den = 13

    def __init__(self, num_batches, seed=0, label_seed=99):
        self.ln_emb = SIZES.copy()
        self.num_batches = num_batches
        self.seed = seed
        lrng = np.random.default_rng(label_seed)
        # 26 x 250k f32 latents = 26 MB host RAM ([T, max] with per-table
        # valid prefix under HETERO)
        self.latents = lrng.normal(
            size=(TABLES, int(SIZES.max()))
        ).astype(np.float32)

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.Generator(np.random.SFC64(self.seed))
        for _ in range(self.num_batches):
            x = rng.random((BATCH, self.m_den), dtype=np.float32)
            u = rng.random((TABLES, BATCH), dtype=np.float32)
            n_t = SIZES[:, None].astype(np.float64)
            if STREAM.startswith("zipf"):
                # bounded Pareto over [1, n_t] (inverse CDF): P(k) ~ k^-a —
                # PRESSURE_STREAM=zipf1.2 etc.; skew axis for the envelope
                a = float(STREAM[4:])
                ls = (
                    ((n_t ** (1.0 - a) - 1.0) * u + 1.0)
                    ** (1.0 / (1.0 - a))
                ).astype(np.int64) - 1
            else:  # loguniform (default): moderate Criteo-like head
                ls = np.exp(u * np.log(n_t)).astype(np.int64) - 1
            ls %= SIZES[:, None]
            v = self.latents[np.arange(TABLES)[:, None], ls].sum(axis=0)
            y = (v > 0).astype(np.float32)[:, None]
            yield Batch(x, ls, None, y)


def _cfg(**kw):
    base = dict(
        arch_sparse_feature_size=DIM,
        arch_mlp_bot=f"13-512-256-{DIM}",  # bot out must equal DIM
        arch_mlp_top="512-256-1",
        mini_batch_size=BATCH,
        world_size=1,
        loss_function="bce",
        lookahead=LOOKAHEAD,
        table_agg_freq=1_000_000,
        print_freq=40,
        learning_rate=float(os.environ.get("PRESSURE_LR", "0.1")),
        lr_embeds=float(os.environ.get("PRESSURE_LR_EMBEDS", "0.5")),
        num_ways=WAYS,
        eviction_fifo_size=256,
        compute_dtype="bfloat16",
        round_targets=True,
        scan_steps=4,
        wire_rows_bf16=os.environ.get("PRESSURE_ROWS_BF16", "1") == "1",
        batch_fifo_size=4,
        # PRESSURE_AVG_WB=1: the reference's --average-on-writeback
        # (cache_manager.py:48-64 averaging arm) — A/B-able under thrash
        average_on_writeback=os.environ.get("PRESSURE_AVG_WB", "0") == "1",
        # PRESSURE_OPT=adagrad: cache-resident row-wise AdaGrad instead of
        # sparse SGD (torchrec semantics; config.optimizer doc);
        # PRESSURE_ADAGRAD_MASTER=1 additionally round-trips the row-wise
        # state through the host AccumulatorStore (adagrad_master_state —
        # the round-5 fix for the measured state-loss thrash gap)
        optimizer=os.environ.get("PRESSURE_OPT", "sgd"),
        adagrad_master_state=(
            os.environ.get("PRESSURE_ADAGRAD_MASTER", "0") == "1"
        ),
        dedup_lookups=(
            "on" if os.environ.get("PRESSURE_OPT") == "adagrad" else "auto"
        ),
        md_flag=MD,
    )
    base.update(kw)
    cfg = Config(**base)
    cfg.finalize(ln_emb=SIZES.copy())
    return cfg


def _run_cached(capacity_frac):
    sets = max(64, int(N_IDS * capacity_frac) // WAYS)
    cfg = _cfg(cache_size=sets)
    train = LatentSignalDataset(STEPS + LOOKAHEAD)
    test = LatentSignalDataset(EVAL_BATCHES, seed=1234)
    t0 = time.perf_counter()
    tr = CachedDlrmTrainer(cfg, train, test)
    final = {}

    def cap(line):
        if tr.last_window is not None:
            final.update(tr.last_window)
        log(f"cap={capacity_frac}: {line}")

    tr.train(max_steps=STEPS, log_fn=cap)
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    rows_written = tr.eviction_manager.rows_written
    tr.close()
    out = {
        "capacity_frac": capacity_frac,
        "rows_per_table": int(np.max(tr.geo.ways * tr.geo.sets)),
        "acc": float(acc), "auc": float(auc),
        "loss": float(final.get("loss", np.nan)),
        "hit_rate": float(final.get("hit_rate", np.nan)),
        "rows_written": int(rows_written),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    log(f"cached {capacity_frac}: {out}")
    return out


def _run_oracle():
    cfg = _cfg(use_cache=False, num_indices_per_lookup=1,
               num_indices_per_lookup_fixed=True)
    train = LatentSignalDataset(STEPS + LOOKAHEAD)
    test = LatentSignalDataset(EVAL_BATCHES, seed=1234)
    t0 = time.perf_counter()
    log("building full-table oracle (3.3 GB HBM tables)...")
    tr = FullTableDlrmTrainer(cfg, train, test)
    tr.train(max_steps=STEPS, log_fn=lambda s: log(f"oracle: {s}"))
    acc, auc = tr.evaluate(log_fn=lambda s: None)
    tr.close()
    out = {"acc": float(acc), "auc": float(auc),
           "wall_s": round(time.perf_counter() - t0, 1)}
    log(f"oracle: {out}")
    return out


def main():
    import jax

    from cdlrm_tpu.utils.device import enable_compile_cache, require_gpu

    if os.environ.get("PRESSURE_CPU"):  # smoke mode: run on the CPU
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu("bench_pressure.py (PRESSURE_CPU=1 for the smoke)")
    enable_compile_cache()
    log(f"backend={jax.default_backend()}, steps={STEPS}")

    # imports AFTER the compilation-cache config (bench.py pattern)
    global Config, Batch, FullTableDlrmTrainer, CachedDlrmTrainer
    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.synthetic import Batch
    from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer

    # PRESSURE_ORACLE="acc,auc": reuse a previously-measured oracle point
    # instead of re-running it. Valid ONLY when the oracle-visible inputs
    # are unchanged (stream/steps/lrs/optimizer/hetero — NOT ways or caps,
    # which the oracle never sees); the artifact rows pin this: the same
    # oracle is deterministic given those inputs.
    if os.environ.get("PRESSURE_ORACLE"):
        acc_s, auc_s = os.environ["PRESSURE_ORACLE"].split(",")
        oracle = {"acc": float(acc_s), "auc": float(auc_s), "reused": True}
        log(f"oracle reused: {oracle}")
    else:
        oracle = _run_oracle()
    # capacity points: 30%/10% are the paper-style pressure axis, but the
    # lookahead window's UNIQUE set (~15k rows/table at the default
    # geometry) still fits 10% of 250k — window-hit protection then keeps
    # the hit rate ~1 and the miss path never shapes the trajectory. The
    # hardest point sits BELOW the window-unique size so real thrash
    # (set-conflict drops, misses, evictions) is guaranteed in the run the
    # artifact claims it for. Env-overridable: PRESSURE_CAPS=0.3,0.1,0.03
    caps = [
        float(c) for c in
        os.environ.get("PRESSURE_CAPS", "0.3,0.1,0.03").split(",")
    ]
    cached = [_run_cached(c) for c in caps]
    hardest = cached[-1]

    result = {
        "metric": "pressure_auc_gap",
        "backend": jax.default_backend(),
        "steps": STEPS,
        "geometry": {"tables": TABLES, "ids": N_IDS, "dim": DIM,
                     "batch": BATCH, "ways": WAYS, "lookahead": LOOKAHEAD,
                     "stream": STREAM, "hetero": HETERO, "md": MD,
                     "avg_writeback":
                         os.environ.get("PRESSURE_AVG_WB", "0") == "1"},
        "oracle": oracle,
        "cached": cached,
        "pressure_auc_gap": {
            f"{c*100:g}%": round(oracle["auc"] - r["auc"], 4)
            for c, r in zip(caps, cached)
        },
        "pressure_real": bool(
            hardest["hit_rate"] < 0.99 and hardest["rows_written"] > 0
        ),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
