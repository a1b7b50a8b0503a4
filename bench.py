"""Headline benchmark: cached-DLRM training throughput on one GPU.

Measures steady-state examples/sec of the cached train loop (host probe +
packed-miss staging + jitted DP step) on a Terabyte-class per-chip
configuration: 26 tables, sparse dim 128, bot 13-512-256-128,
top 512-256-1 (the reference paper-repro arch, /root/reference/README.md:7),
with a Zipf-skewed index stream approximating Criteo's head-heavy
distribution.

Measurement semantics match the reference's printout
(/root/reference/main_no_ddp.py:458-473): ms/it excludes the lookahead refill
("caching overhead"), which is reported separately, amortized per step. The
lookahead window here covers the whole measured stream (the paper config runs
lookahead=3000 >> any print window).

vs_baseline: the reference repo publishes no numbers (BASELINE.md); the
denominator is a fixed nominal estimate of the reference system's per-GPU
throughput at the paper config (global batch 8192 over 8 V100s at roughly
55 ms/it => ~18.6k examples/s/GPU), rounded to 20,000 examples/s/chip.

Needs a GPU and fails without one; ``BENCH_CPU=1`` runs the same flow at a
small debug geometry on the CPU (a smoke, never a number to report).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import sys
import time

import numpy as np

NOMINAL_BASELINE_EXAMPLES_PER_SEC = 20_000.0


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# production per-card geometry: 26 tables x 250k rows, dim 128, the
# reference paper-repro MLPs, per-card batch 4096
HEADLINE_GEOMETRY = dict(
    num_tables=26, dim=128, batch=4096, table_rows=250_000,
    cache_size=16_384, ways=8, bot="13-512-256-128", top="512-256-1",
    steps=40, warmup=10, ss_lookahead=5, ss_print=10, ss_steps=40,
)
# scaled-down geometry so the bench flow is debuggable on the CPU
DEBUG_GEOMETRY = dict(
    num_tables=8, dim=32, batch=512, table_rows=20_000,
    cache_size=2_048, ways=4, bot="13-64-32", top="64-32-1",
    steps=20, warmup=5, ss_lookahead=4, ss_print=8, ss_steps=32,
)


def resolve_geometry(backend: str, cpu_ok: bool) -> dict:
    """The headline geometry on a GPU; the debug geometry on the CPU only
    when asked for (``BENCH_CPU=1``); otherwise raise — a measurement never
    falls back to the CPU silently."""
    if backend == "gpu":
        return dict(HEADLINE_GEOMETRY)
    if backend == "cpu" and cpu_ok:
        return dict(DEBUG_GEOMETRY)
    raise RuntimeError(
        f"bench.py needs a GPU (JAX backend is {backend!r}); set BENCH_CPU=1 "
        "for the CPU smoke at the debug geometry"
    )


def main():
    import jax

    # BENCH_CPU=1: force the CPU backend in-process — the full bench flow
    # at the debuggable geometry, for the bitrot smoke
    # (tests/test_bench_harnesses.py); never a number to report
    cpu_ok = bool(os.environ.get("BENCH_CPU"))
    if cpu_ok:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.synthetic import Batch
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer
    from cdlrm_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    geo = resolve_geometry(jax.default_backend(), cpu_ok)
    num_tables, dim, batch = geo["num_tables"], geo["dim"], geo["batch"]
    table_rows, cache_size, ways = (
        geo["table_rows"], geo["cache_size"], geo["ways"]
    )
    bot, top = geo["bot"], geo["top"]
    steps, warmup = geo["steps"], geo["warmup"]
    if not cpu_ok:
        # BENCH_BATCH overrides the per-card batch (A/B knob only; the
        # headline stays at the paper's per-card batch)
        batch = int(os.environ.get("BENCH_BATCH", batch))

    total_batches = steps + warmup
    lookahead = total_batches + 4  # single window covers the whole run

    ln_emb = np.full(num_tables, table_rows, dtype=np.int64)
    cfg = Config(
        arch_sparse_feature_size=dim,
        arch_mlp_bot=bot,
        arch_mlp_top=top,
        mini_batch_size=batch,
        world_size=1,
        cache_size=cache_size,
        num_ways=ways,
        loss_function="bce",
        lookahead=lookahead,
        table_agg_freq=1_000_000,  # single chip: no aggregation needed
        print_freq=1_000_000,
        round_targets=True,
        compute_dtype="bfloat16",
        batch_fifo_size=4,
        # virtual (procedural) masters: materializing 3+ GB of tables would
        # dominate the run's set-up; gather/writeback cost is equivalent
        # (see cache/master.py)
        master_init="virtual",
        # duplicate-slot coalescing: 'auto' — the production default —
        # lets each window's measured duplication pick the wire;
        # BENCH_DEDUP=on/off pins it for A/Bs ('1'/'0' accepted)
        dedup_lookups={"1": "on", "0": "off"}.get(
            os.environ.get("BENCH_DEDUP", "auto"),
            os.environ.get("BENCH_DEDUP", "auto"),
        ),
        # scan blocks: one dispatch per 10 steps (config.py scan_steps).
        # BENCH_SCAN=1 for the A/B.
        scan_steps=int(os.environ.get("BENCH_SCAN", "10")),
        # fp8 dense-feature wire: x is the second-largest H2D payload — but
        # it is LOSSY (config.py), so the HEADLINE stays on the lossless wire;
        # BENCH_FP8=1 opts into the fp8 A/B (flag polarity matches
        # BENCH_DEDUP/BENCH_SCAN: 1 enables the named feature).
        wire_x_fp8=os.environ.get("BENCH_FP8", "0") == "1",
        # hot-tier update (config.hot_tier_rows): BENCH_HOT=<H> enables
        hot_tier_rows=int(os.environ.get("BENCH_HOT", "0")),
        # BENCH_PACK=0: unpacked wires (PCIe-host mode; int32 slots/ranks,
        # no device wire decode; ~2.3x the wire bytes).
        pack_wire=os.environ.get("BENCH_PACK", "1") == "1",
        # BENCH_BLOCK: the block-coalesced sparse update — per-lookup grads
        # into a small pending buffer, ONE cache scatter per scan block
        # (config.py block_coalesced_update). Default 'auto' = on exactly
        # when legal (so BENCH_PACK=0 alone runs coalesced); BENCH_BLOCK=0
        # is the A/B control, BENCH_BLOCK=1 forces it (raises if illegal).
        block_coalesced_update={"1": "on", "0": "off"}.get(
            os.environ.get("BENCH_BLOCK", "auto"),
            os.environ.get("BENCH_BLOCK", "auto"),
        ),
        # BENCH_OPT=adagrad (with BENCH_DEDUP=on): row-wise AdaGrad — the
        # step-cost A/B of the cache-resident state ride-along
        optimizer=os.environ.get("BENCH_OPT", "sgd"),
        # BENCH_SORTED=1 (requires BENCH_PACK=0 BENCH_DEDUP=on): ascending
        # unique slots + indices_are_sorted scatters (config.py
        # sorted_dedup_wire)
        sorted_dedup_wire=os.environ.get("BENCH_SORTED", "0") == "1",
        # BENCH_PRESTAGE=0: disable the refill prestager (config.py
        # refill_prestage; default on) — the A/B shows up in the
        # steady-state regime's caching_overhead_ms_per_iter (the headline
        # timed region contains no refills by construction)
        refill_prestage=os.environ.get("BENCH_PRESTAGE", "1") == "1",
    )
    cfg.finalize(ln_emb=ln_emb)

    # stream model: 'loguniform' (default; moderate Criteo-like head
    # concentration, per-batch unique ~0.57N) or 'zipf12' (true zipf(1.2),
    # the duplicate-heavy shape where a plain scatter forms long same-index
    # chains; the auto-dedup guard must keep the step flat here)
    stream = os.environ.get("BENCH_STREAM", "loguniform")

    class ZipfDataset:
        """Skewed single-index stream (Criteo-like head concentration)."""

        m_den = 13

        def __init__(self, num_batches, seed=0):
            self.ln_emb = ln_emb
            self.num_batches = num_batches
            self.seed = seed

        def __len__(self):
            return self.num_batches

        def batches(self):
            rng = np.random.Generator(np.random.SFC64(self.seed))
            for _ in range(self.num_batches):
                x = rng.random((batch, 13), dtype=np.float32)
                if stream.startswith("zipf"):
                    # zipf12 / zipf15 / ... -> exponent 1.2 / 1.5 / ...
                    a = float(stream[4:]) / 10.0
                    idx = (
                        rng.zipf(a, size=(num_tables, batch)) - 1
                    ) % table_rows
                elif stream == "uniform":  # near-unique (U ~ 0.97N/batch)
                    idx = rng.integers(
                        0, table_rows, size=(num_tables, batch)
                    )
                else:
                    u = rng.random((num_tables, batch), dtype=np.float32)
                    idx = np.exp(u * np.log(table_rows)).astype(np.int64) - 1
                    np.minimum(idx, table_rows - 1, out=idx)
                y = np.round(rng.random((batch, 1), dtype=np.float32))
                yield Batch(x, idx, None, y)

    ds = ZipfDataset(total_batches)
    eval_ds = ZipfDataset(12, seed=1)
    log(f"building trainer (tables={num_tables}x{table_rows}, dim={dim}, "
        f"cache rows/table={cfg.cache_sets * ways + batch})")
    t0 = time.perf_counter()
    trainer = CachedDlrmTrainer(cfg, ds, eval_ds)
    log(f"trainer ready in {time.perf_counter()-t0:.1f}s")

    # drive the REAL training loop (pipelined probe/staging overlaps the
    # device step); first print-window = warmup (compiles + refill),
    # the rest are the measurement
    cfg.print_freq = warmup
    windows = []

    def capture(line):
        if trainer.last_window is not None:
            windows.append(dict(trainer.last_window))
        log(line)

    trainer.train(max_steps=warmup + steps, log_fn=capture)
    jax.block_until_ready(trainer.cache)

    # device-step-only timing, reused inputs, synced by chained donated
    # calls ending in a scalar D2H
    h2d_bytes = {"n": 0}

    def device_step_ms(iters=30):
        b0 = next(ds.batches())
        inputs, _, dd, _binfo = trainer._assemble(b0, cfg.local_batch_size)
        # per-step H2D payload accounting (the binding constraint on thin
        # host links): bytes of every staged input
        h2d_bytes["n"] = int(sum(getattr(a, "nbytes", 0) for a in inputs))
        hot_extra = (trainer._hot_slots_dev,) if trainer._hot else ()
        fn = trainer._get_step(1, dd)
        p, c, t = trainer.params, trainer.cache, trainer.touched
        if trainer._adagrad:
            da, ea = trainer.dense_acc, trainer.embed_acc
            p, c, t, da, ea, ls, _ = fn(p, c, t, *inputs, da, ea,
                                        trainer._lr, trainer._lr_emb)
            _ = float(ls)  # compile + sync
            t0 = time.perf_counter()
            for _ in range(iters):
                p, c, t, da, ea, ls, _ = fn(p, c, t, *inputs, da, ea,
                                            trainer._lr, trainer._lr_emb)
            _ = float(ls)
            trainer.dense_acc, trainer.embed_acc = da, ea
        else:
            p, c, t, ls, _ = fn(p, c, t, *inputs, *hot_extra,
                                trainer._lr, trainer._lr_emb)
            _ = float(ls)  # compile + sync
            t0 = time.perf_counter()
            for _ in range(iters):
                p, c, t, ls, _ = fn(p, c, t, *inputs, *hot_extra,
                                    trainer._lr, trainer._lr_emb)
            _ = float(ls)
        dt = 1e3 * (time.perf_counter() - t0) / iters
        trainer.params, trainer.cache, trainer.touched = p, c, t
        return dt

    dstep_ms = device_step_ms()

    def device_block_ms(iters=6):
        """Per-step device time of the SCAN-BLOCK dispatch (the unit the
        headline wall actually runs) with reused inputs — the number where
        block coalescing shows up: the single-step fn above never coalesces
        (the flush amortizes over a block). Returns (ms_per_step,
        coalesced?, union_host_ms_per_block) or None when blocks are off
        or the optimizer path needs per-step state (adagrad blocks are
        timed by the headline wall instead)."""
        k = trainer._scan_block
        if k <= 1 or trainer._adagrad:
            return None
        gen = ds.batches()
        items = []
        for _ in range(k):
            bi = next(gen)
            inputs, _, ddb, binfo = trainer._assemble(bi, cfg.local_batch_size)
            items.append((inputs, ddb, binfo))
        ddb = items[0][1]
        if not all(it[1] == ddb for it in items):
            return None  # auto-dedup flipped mid-probe; skip the metric
        coalesce = (
            ddb and trainer._block_coalesce
            and all(it[2] is not None for it in items)
        )
        fn = trainer._get_step(k, ddb, coalesce)
        hot_extra = (trainer._hot_slots_dev,) if trainer._hot else ()
        union_ms = 0.0
        if coalesce:
            tu = time.perf_counter()
            ranks, blk_slots, blk_counts = trainer._build_block_union(
                [it[2] for it in items]
            )
            union_ms = 1e3 * (time.perf_counter() - tu)
            # the rank-row interleave lives in ONE place (trainer method)
            # so the step's batch_specs order cannot drift between the
            # train loop and this probe
            flat = trainer.interleave_block_inputs(
                [inputs for inputs, _, _ in items], ranks
            )
            tail = (blk_slots, blk_counts)
        else:
            flat = [a for inputs, _, _ in items for a in inputs]
            tail = hot_extra
        p, c, t = trainer.params, trainer.cache, trainer.touched
        out = fn(p, c, t, *flat, *tail, trainer._lr, trainer._lr_emb)
        p, c, t, ls = out[0], out[1], out[2], out[-2]
        _ = float(jnp.sum(ls))  # compile + sync
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(p, c, t, *flat, *tail, trainer._lr, trainer._lr_emb)
            p, c, t, ls = out[0], out[1], out[2], out[-2]
        _ = float(jnp.sum(ls))
        dt = 1e3 * (time.perf_counter() - t0) / (iters * k)
        trainer.params, trainer.cache, trainer.touched = p, c, t
        return dt, bool(coalesce), union_ms

    blk = device_block_ms()

    # BENCH_SKIP_EXTRAS=1: A/B mode — headline + device_step only (the
    # hot-tier / wire A/Bs need many runs; eval + steady-state regimes are
    # invariant to those knobs)
    if os.environ.get("BENCH_SKIP_EXTRAS", "0") == "1":
        timed = windows[1:] if len(windows) > 1 else windows
        n_steps = sum(w["steps"] for w in timed)
        ms_per_iter = sum(w["ms_per_iter"] * w["steps"] for w in timed) / n_steps
        w = windows[-1]
        print(json.dumps({
            "metric": "cached_dlrm_train_examples_per_sec_per_chip",
            "value": round(1000.0 * batch / ms_per_iter, 1),
            "ms_per_iter": round(ms_per_iter, 2),
            "device_step_ms": round(dstep_ms, 2),
            # scan-block dispatch per-step time (the coalesce A/B metric)
            "block_step_ms_per_iter": (
                None if blk is None else round(blk[0], 2)
            ),
            "block_coalesced": None if blk is None else blk[1],
            "block_union_host_ms": None if blk is None else round(blk[2], 2),
            "hit_rate": round(w["hit_rate"], 4),
            "dedup_active": bool(w.get("dedup", False)),
            "batch": batch, "stream": stream,
            "hot_tier_rows": cfg.hot_tier_rows,
            "h2d_bytes_per_step": h2d_bytes["n"],
        }))
        trainer.close()
        return

    # serving path: forward-only eval throughput (host probe + staging +
    # cached eval step, misses served from the masters), steady state over
    # the held-out stream — the --inference-only serving surface. PIPELINED
    # since round 4: assembly of batch i+1 overlaps the forward of batch i,
    # and the scores D2H lags one batch (trainer.evaluate).
    trainer.evaluate(max_batches=2, log_fn=lambda s: None)  # compile
    t0 = time.perf_counter()
    eval_batches = 10
    trainer.evaluate(max_batches=eval_batches, log_fn=lambda s: None)
    eval_dt = time.perf_counter() - t0
    eval_eps = eval_batches * batch / eval_dt
    trainer.close()

    # steady-state regime: a second timed run whose measurement region
    # contains MULTIPLE refill windows, so the headline
    # is accompanied by a number that includes the caching tax at a
    # realistic window cadence (the single-window headline's timed region
    # has zero refills by construction). Reference anchor: amortized
    # caching-overhead reporting, main_no_ddp.py:458-473. bf16 row wire
    # halves the refill H2D; window cadence = lookahead 5 over 3 timed
    # print-windows = 6 refills in the measurement.
    ss_lookahead, ss_print, ss_steps = (
        geo["ss_lookahead"], geo["ss_print"], geo["ss_steps"]
    )
    cfg_ss = Config(
        arch_sparse_feature_size=dim,
        arch_mlp_bot=bot,
        arch_mlp_top=top,
        mini_batch_size=batch,
        world_size=1,
        cache_size=cache_size,
        num_ways=ways,
        loss_function="bce",
        lookahead=ss_lookahead,
        table_agg_freq=1_000_000,
        print_freq=ss_print,
        round_targets=True,
        compute_dtype="bfloat16",
        batch_fifo_size=4,
        master_init="virtual",
        dedup_lookups=cfg.dedup_lookups,
        scan_steps=min(cfg.scan_steps, ss_lookahead),
        wire_x_fp8=cfg.wire_x_fp8,
        wire_rows_bf16=True,
        pack_wire=cfg.pack_wire,
        # the BENCH_PRESTAGE A/B lives HERE — the headline's timed region
        # has no refills, so the knob must reach this regime's config
        refill_prestage=cfg.refill_prestage,
        # BENCH_BLOCK must pin this regime too: since the default went to
        # 'auto', an unforwarded knob would silently resolve ON here
        # (scan>1 + unpacked dedup + sgd), making the BENCH_BLOCK=0
        # control arm's steady-state section coalesced like the treatment
        block_coalesced_update=cfg.block_coalesced_update,
    )
    cfg_ss.finalize(ln_emb=ln_emb)
    log(f"steady-state regime: lookahead={ss_lookahead}, {ss_steps} steps")
    tr_ss = CachedDlrmTrainer(cfg_ss, ZipfDataset(ss_steps + 4, seed=2))
    ss_windows = []

    def cap_ss(line):
        if tr_ss.last_window is not None:
            ss_windows.append(dict(tr_ss.last_window))
        log(f"[steady] {line}")

    tr_ss.train(max_steps=ss_steps, log_fn=cap_ss)
    jax.block_until_ready(tr_ss.cache)
    ss_refills = tr_ss.metrics.refills
    tr_ss.close()
    ss_timed = ss_windows[1:] if len(ss_windows) > 1 else ss_windows
    ss_n = sum(w["steps"] for w in ss_timed)
    ss_ms = sum(w["ms_per_iter"] * w["steps"] for w in ss_timed) / max(1, ss_n)
    ss_overhead = sum(
        w["caching_overhead_ms"] * w["steps"] for w in ss_timed
    ) / max(1, ss_n)
    ss_eps = 1000.0 * batch / max(1e-9, ss_ms + ss_overhead)

    timed = windows[1:] if len(windows) > 1 else windows
    n_steps = sum(w["steps"] for w in timed)
    ms_per_iter = sum(w["ms_per_iter"] * w["steps"] for w in timed) / n_steps
    w = windows[-1]
    examples_per_sec = 1000.0 * batch / ms_per_iter
    result = {
        "metric": "cached_dlrm_train_examples_per_sec_per_chip",
        "value": round(examples_per_sec, 1),
        "unit": "examples/s",
        "vs_baseline": round(examples_per_sec / NOMINAL_BASELINE_EXAMPLES_PER_SEC, 3),
        "hit_rate": round(w["hit_rate"], 4),
        "ms_per_iter": round(ms_per_iter, 2),
        "caching_overhead_ms_per_iter": round(
            sum(x["caching_overhead_ms"] * x["steps"] for x in timed) / n_steps, 2
        ),
        # reused-inputs device-bound step: the wall on PCIe hosts where the
        # H2D link is not the constraint (includes dispatch; excludes host
        # probe + staging, which overlap under the pipeline)
        "device_step_ms": round(dstep_ms, 2),
        # scan-block dispatch per-step device time + whether the block ran
        # coalesced (config.py block_coalesced_update; None when blocks
        # are off) — the granularity the headline wall actually dispatches
        "block_step_ms_per_iter": None if blk is None else round(blk[0], 2),
        "block_coalesced": None if blk is None else blk[1],
        "block_union_host_ms": None if blk is None else round(blk[2], 2),
        # forward-only serving throughput (the --inference-only path). The
        # eval stream is a fresh sample, so its tail misses the train-window
        # cache and ships master rows over the host link (eval_hit_rate).
        "eval_examples_per_sec": round(eval_eps, 1),
        "eval_hit_rate": round(trainer.metrics.eval_hit_rate, 4),
        # with-refills throughput at window cadence `steady_lookahead`
        # (examples / (step + amortized refill) — the caching tax included;
        # ≥3 window boundaries inside the timed region).
        "steady_state_examples_per_sec": round(ss_eps, 1),
        "steady_state_ms_per_iter": round(ss_ms, 2),
        "steady_state_caching_overhead_ms_per_iter": round(ss_overhead, 2),
        "steady_lookahead": ss_lookahead,
        "steady_refills": int(ss_refills),
        # staged input bytes per train step (wire accounting; excludes the
        # per-window refill traffic, which amortizes over lookahead)
        "h2d_bytes_per_step": h2d_bytes["n"],
        "timed_steps": n_steps,
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "config": {
            "tables": num_tables, "dim": dim, "batch": batch,
            "cache_sets": int(cfg.cache_sets), "ways": ways,
            "lookahead": lookahead, "compute_dtype": "bfloat16",
            "scan_steps": cfg.scan_steps,
            "x_wire": "fp8" if cfg.wire_x_fp8 else "bf16",
            "dedup": cfg.dedup_lookups,  # requested mode (on|off|auto)
            # what auto actually chose for the final window (w["dedup"])
            "dedup_active": bool(w.get("dedup", False)),
            "stream": stream,
            "hot_tier_rows": cfg.hot_tier_rows,
            "pack_wire": cfg.pack_wire,
            # finalize() resolved auto to a bool (config.py)
            "block_coalesced": bool(cfg.block_coalesced_update),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
