#!/usr/bin/env python
"""Chip smoke: the quickest proof that the cached-DLRM trainer runs on a GPU.

  python chip_smoke.py               # one card
  python chip_smoke.py --four-cards  # four cards: the data-parallel phase only

One card runs these phases, in one process:

1. device: a GPU must be JAX's backend (never the CPU); prints the card's
   ``nvidia-smi`` name and power limit, device kind, JAX version, compile
   cache directory and whether the native host library or its numpy
   fallback runs.
2. kernels: XLA's gather, distinct-row scatter-add and insert set at the
   headline shapes (bench_kernels.py), each checked against numpy at full
   width and timed against the card's HBM roofline.
3. main path: ``cdlrm_tpu.cli.main`` at the reference paper's widths (26
   tables x 250k rows, dim 128, bottom MLP 13-512-256-128, top MLP
   512-512-256-1, per-card batch 4096, bf16), three arms that between them
   run the three compiled train-step bodies, with refills, evictions and
   writebacks inside the run, then evaluation. Numbers are read from the
   ``--metrics-log`` JSON lines.
4. reference: the cached trainer, fully resident, against the full-table
   trainer (train/fulltable.py) on the same stream at f32 under
   ``jax.default_matmul_precision("highest")``.

``--four-cards`` runs only the data-parallel phase: the cached trainer at
world size 4 with the strict and the delta refill broadcast, each against
the full-table trainer on the same four cards.

The last stdout line is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": N}}``, printed only when every phase passed; a failed
phase exits non-zero before it.
"""

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

# reference paper widths (BASELINE.md) at bench.py's table scale
DIM = 128
BOT = "13-512-256-128"
TOP = "512-512-256-1"
TABLES = 26
ROWS = 250_000
BATCH = 4096  # per card
CACHE_SIZE, WAYS = 16_384, 8  # main path: 16,411 sets x 8 ways per table

# cached vs full-table tolerance. Both trainers apply the same SGD updates
# in f32 at "highest" matmul precision (no TF32), but XLA:GPU lowers
# scatter-add to atomics, so gradients of ids that repeat within a batch
# are summed in an order that changes from run to run, and the two paths
# sum them through different scatters. That reorders f32 sums (~1e-7
# relative per add); over 20 steps it stays well under 1e-4.
RTOL, ATOL = 1e-4, 1e-6
TOL_REASON = (
    "f32 at 'highest' precision; atomic scatter-add reorders the sums of "
    "repeated ids between runs and between the two paths"
)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card data-parallel phase",
    )
    ap.add_argument("--seed", type=int, default=123)
    return ap.parse_args(argv)


def phases_for(four_cards: bool) -> list:
    if four_cards:
        return ["device", "data_parallel"]
    return ["device", "kernels", "main_path", "reference"]


# ---------------------------------------------------------------- phase 1
def phase_device(need: int) -> dict:
    import jax

    from cdlrm_tpu.ops import native
    from cdlrm_tpu.utils.device import (
        enable_compile_cache, query_gpus, require_gpu,
    )

    require_gpu("chip_smoke.py")
    devices = jax.devices()
    if len(devices) < need:
        raise RuntimeError(f"need {need} GPUs, JAX found {len(devices)}")
    gpus = query_gpus()
    if not gpus:
        raise RuntimeError("nvidia-smi lists no card")
    for g in gpus:
        print(g.line, flush=True)  # name, power limit as nvidia-smi gives them
    label = f"{gpus[0].name}, power limit {gpus[0].power_limit_w} W"
    log(f"device_kind: {devices[0].device_kind} x {len(devices)}")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {enable_compile_cache()}")
    lib = native.library_path()
    log("native host library: "
        + (f"loaded ({lib})" if lib else "NOT loaded, numpy fallbacks run"))
    return {"label": label, "kind": devices[0].device_kind}


# ---------------------------------------------------------------- phase 2
def phase_kernels(info: dict) -> None:
    import bench_kernels
    from cdlrm_tpu.utils.device import device_peak

    try:
        peak = device_peak(info["kind"]).hbm_gbps
    except KeyError as e:
        log(f"roofline share not measured: {e}")
        peak = None
    for rec in bench_kernels.time_sparse_kernels(peak_gbps=peak):
        log(f"kernel {json.dumps(rec)} [{info['label']}]")


# ---------------------------------------------------------------- phase 3
def main_path_argv(arm: str, metrics_log: str, seed: int, steps: int):
    argv = [
        "--data-generation", "random",
        "--arch-embedding-size", "-".join([str(ROWS)] * TABLES),
        "--arch-sparse-feature-size", str(DIM),
        "--arch-mlp-bot", BOT, "--arch-mlp-top", TOP,
        "--loss-function", "bce", "--round-targets",
        "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed",
        "--mini-batch-size", str(BATCH),
        "--test-mini-batch-size", str(BATCH),
        "--num-batches", str(steps),
        "--cache-size", str(CACHE_SIZE), "--num-ways", str(WAYS),
        # short windows: refills, evictions and writebacks all happen
        # within the run; print windows align with refill windows
        "--lookahead", "8", "--print-freq", "8",
        "--compute-dtype", "bfloat16", "--master-init", "virtual",
        "--numpy-rand-seed", str(seed), "--world-size", "1",
        "--metrics-log", metrics_log,
    ]
    extra = {
        # packed wire, auto-dedup (the uniform stream picks the plain wire)
        "a_default": [],
        # unpacked dedup wire in scan blocks: block coalescing resolves on
        "b_coalesce": ["--dedup-lookups", "on", "--no-pack-wire",
                       "--scan-steps", "10"],
        # row-wise AdaGrad on the dedup wire, at AdaGrad-scale rates
        "c_adagrad": ["--optimizer", "adagrad", "--dedup-lookups", "on",
                      "--learning-rate", "0.01", "--lr-embeds", "0.05"],
    }[arm]
    return argv + extra


def check_arm(arm: str, records: list) -> dict:
    windows = [r for r in records if r["kind"] == "train_window"]
    evals = [r for r in records if r["kind"] == "eval"]
    if not windows or not evals:
        raise AssertionError(f"{arm}: metrics log lacks train/eval records")
    last = windows[-1]
    losses = [w["loss"] for w in windows]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{arm}: non-finite loss {losses}")
    for key in ("hit_rate", "rows_written", "refills"):
        if not last[key] > 0:
            raise AssertionError(f"{arm}: {key} = {last[key]}, want > 0")
    ev = evals[-1]
    if ev["auc"] is None or not (
        math.isfinite(ev["accuracy"]) and math.isfinite(ev["auc"])
    ):
        raise AssertionError(f"{arm}: eval accuracy/AUC not finite: {ev}")
    timed = windows[1:] or windows  # the first window compiles
    steps = sum(w["steps"] for w in timed)
    ms = sum(w["ms_per_iter"] * w["steps"] for w in timed) / steps
    return {"arm": arm, "ms_per_iter": ms, "losses": losses,
            "hit_rate": last["hit_rate"], "refills": last["refills"],
            "rows_written": last["rows_written"], "dedup": last["dedup"],
            "eval_accuracy": ev["accuracy"], "eval_auc": ev["auc"]}


def phase_main_path(info: dict, seed: int, steps: int = 48) -> None:
    from cdlrm_tpu import cli
    from cdlrm_tpu.config import config_from_args

    with tempfile.TemporaryDirectory() as td:
        for arm in ("a_default", "b_coalesce", "c_adagrad"):
            path = os.path.join(td, f"{arm}.jsonl")
            argv = main_path_argv(arm, path, seed, steps)
            cfg = config_from_args(argv).finalize()
            if arm == "b_coalesce" and cfg.block_coalesced_update is not True:
                raise AssertionError("arm b: block coalescing did not resolve on")
            t0 = time.perf_counter()
            rc = cli.main(argv)
            if rc != 0:
                raise AssertionError(f"{arm}: cli.main returned {rc}")
            with open(path) as f:
                rec = check_arm(arm, [json.loads(ln) for ln in f])
            log(f"main path {arm}: {rec['ms_per_iter']:.2f} ms/it, "
                f"hit rate {rec['hit_rate']:.4f}, refills {rec['refills']}, "
                f"rows written {rec['rows_written']}, eval acc "
                f"{rec['eval_accuracy']:.4f} AUC {rec['eval_auc']:.4f}, "
                f"wall {time.perf_counter() - t0:.1f} s [{info['label']}]")
            log(f"main path {arm} record: {json.dumps(rec)}")
            gc.collect()


# ---------------------------------------------------------------- phase 4
def resident_argv(world: int, rows: int, steps: int, seed: int,
                  refill_broadcast: str):
    return [
        "--data-generation", "random",
        "--arch-embedding-size", "-".join([str(rows)] * TABLES),
        "--arch-sparse-feature-size", str(DIM),
        "--arch-mlp-bot", BOT, "--arch-mlp-top", TOP,
        "--loss-function", "bce", "--round-targets",
        "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed",
        "--mini-batch-size", str(BATCH * world),
        "--num-batches", str(steps),
        # cache sets >= table rows: every id keeps its own set, nothing is
        # ever evicted, and the cached path must train exactly like the
        # full tables
        "--cache-size", str(rows), "--num-ways", "2",
        "--lookahead", "4", "--print-freq", "1",
        # aggregate every step (mean): per-replica updates then equal the
        # full-table trainer's pmean'd gradients; 1 divides the lookahead,
        # so the delta broadcast stays trajectory-equal to strict
        "--table-agg-freq", "1", "--refill-broadcast", refill_broadcast,
        "--compute-dtype", "float32", "--master-init", "uniform",
        "--numpy-rand-seed", str(seed), "--world-size", str(world),
    ]


def _replica0(arr) -> np.ndarray:
    shard = min(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.asarray(shard.data)


def run_cached_resident(argv, steps: int) -> dict:
    """Train the cached trainer; return its initial dense params and master
    tables, its per-step losses and, per table, the seen ids with their
    final cache rows (replica 0)."""
    import jax

    from cdlrm_tpu.cli import build_dataset
    from cdlrm_tpu.config import config_from_args
    from cdlrm_tpu.train import step as step_lib
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer

    train_ds, _, cfg = build_dataset(config_from_args(argv))
    if not all(int(n) <= cfg.cache_sets for n in cfg.ln_emb):
        raise AssertionError("resident geometry is not fully resident")
    tr = CachedDlrmTrainer(cfg, train_ds)
    try:
        p0 = step_lib.unreplicate(tr.params)
        tables0 = [tr.master.tables[t].copy() for t in range(TABLES)]
        losses = []
        with jax.default_matmul_precision("highest"):
            tr.train(max_steps=steps,
                     log_fn=lambda s: losses.append(tr.last_window["loss"]))
        devices = sorted({str(s.device) for s in tr.cache.addressable_shards})
        cache0 = _replica0(tr.cache)
        seen = []
        for t in range(TABLES):
            ids = np.unique(np.concatenate(
                [b.ls_i[t].ravel() for i, b in enumerate(train_ds.batches())
                 if i < steps]))
            sets_t = int(tr.geo.sets[t])
            occ = tr.controller.occupancy[t]
            eq = occ[ids % sets_t] == ids[:, None]
            if not eq.any(axis=1).all():
                raise AssertionError(f"table {t}: seen ids not resident")
            slots = (tr.geo.table_offsets[t] + eq.argmax(axis=1) * sets_t
                     + ids % sets_t)
            seen.append((ids, cache0[slots]))
    finally:
        tr.close()
    return {"p0": p0, "tables0": tables0, "losses": losses, "seen": seen,
            "devices": devices, "ds": train_ds, "cfg": cfg}


def run_fulltable(run: dict, steps: int) -> dict:
    """The plain reference: full tables resident on the same devices,
    started from the cached run's initial values, driven step by step on
    the same stream."""
    import jax

    from cdlrm_tpu.train import step as step_lib
    from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer

    cfg = run["cfg"]
    full = FullTableDlrmTrainer(cfg, run["ds"])
    full.params = step_lib.replicate_for_mesh(
        {"bot": run["p0"]["bot"], "top": run["p0"]["top"],
         "emb": run["tables0"]}, full.mesh,
    )
    losses = []
    with jax.default_matmul_precision("highest"):
        for i, batch in enumerate(run["ds"].batches()):
            if i >= steps:
                break
            full.params, loss_sum, _ = full.train_step(
                full.params, *full._put(batch), full._lr, full._lr_emb)
            losses.append(float(loss_sum) / cfg.mini_batch_size)
    rows = []
    for t, (ids, _) in enumerate(run["seen"]):
        table = full.params["emb"][t]
        rows.append(np.asarray(_replica0(table)[0][ids]))
    devices = sorted({str(s.device) for s in full.params["emb"][0]
                      .addressable_shards})
    return {"losses": losses, "rows": rows, "devices": devices}


def compare(name: str, cached: dict, full: dict) -> dict:
    lc, lf = np.asarray(cached["losses"]), np.asarray(full["losses"])
    if lc.shape != lf.shape:
        raise AssertionError(f"{name}: {lc.size} vs {lf.size} steps")
    loss_rel = float(np.max(np.abs(lc - lf) / np.abs(lf)))
    row_abs = row_used = 0.0
    for (ids, got), want in zip(cached["seen"], full["rows"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: cached rows")
        err = np.abs(got - want)
        row_abs = max(row_abs, float(err.max()))
        # share of the tolerance used: <= 1 passes
        row_used = max(row_used, float(np.max(
            err / (ATOL + RTOL * np.abs(want)))))
    np.testing.assert_allclose(lc, lf, rtol=RTOL,
                               err_msg=f"{name}: per-step loss")
    n_ids = sum(ids.size for ids, _ in cached["seen"])
    log(f"{name}: {lc.size} steps, max loss rel diff {loss_rel:.3g}; "
        f"{n_ids} trained ids, max row abs diff {row_abs:.3g}, "
        f"{row_used:.3g} of the tolerance used; tolerance rtol {RTOL} "
        f"atol {ATOL} ({TOL_REASON})")
    return {"loss_rel": loss_rel, "row_abs": row_abs, "row_used": row_used}


def phase_reference(info: dict, seed: int, steps: int = 20) -> None:
    argv = resident_argv(1, ROWS, steps, seed, "strict")
    cached = run_cached_resident(argv, steps)
    full = run_fulltable(cached, steps)
    compare(f"cached vs full-table, 1 card [{info['label']}]", cached, full)


def phase_data_parallel(info: dict, seed: int, steps: int = 12) -> None:
    import jax

    world = 4
    log(f"mesh: dp over {[str(d) for d in jax.devices()[:world]]}")
    full = None
    for mode in ("strict", "delta"):
        argv = resident_argv(world, ROWS, steps, seed, mode)
        cached = run_cached_resident(argv, steps)
        log(f"{mode}: cache shards on {cached['devices']}")
        if len(cached["devices"]) != world:
            raise AssertionError(f"{mode}: cache spans {cached['devices']}")
        if full is None:  # one oracle: same seed, stream and init
            full = run_fulltable(cached, steps)
            log(f"full-table shards on {full['devices']}")
        compare(f"4-card cached ({mode} refill) vs 4-card full-table "
                f"[{info['label']}]", cached, full)
        del cached
        gc.collect()


def main(argv=None) -> int:
    args = parse_args(argv)
    need = 4 if args.four_cards else 1
    info = None
    for phase in phases_for(args.four_cards):
        t0 = time.perf_counter()
        log(f"phase {phase}")
        if phase == "device":
            info = phase_device(need)
        elif phase == "kernels":
            phase_kernels(info)
        elif phase == "main_path":
            phase_main_path(info, args.seed)
        elif phase == "reference":
            phase_reference(info, args.seed)
        elif phase == "data_parallel":
            phase_data_parallel(info, args.seed)
        log(f"phase {phase} passed in {time.perf_counter() - t0:.1f} s")
    import jax

    dev = jax.devices()
    print(result_line(dev[0].platform, dev[0].device_kind, len(dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
