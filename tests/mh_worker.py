"""Multi-host test worker: one JAX process of an N-process CPU cluster.

Launched by tests/test_multihost.py. Trains the cached DLRM on a seeded
synthetic stream and writes per-window losses + eval metrics as JSON so the
parent can compare runs across process topologies (1x4 vs 2x2 devices must
produce the same training trajectory — same global mesh, same data, and
bit-identical procedural masters; see parallel/multihost.py)."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    ndev_local = int(sys.argv[3])
    port = sys.argv[4]
    outfile = sys.argv[5]
    mode = sys.argv[6]  # "one_window" | "multi_window"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", ndev_local)
    if nproc > 1:
        jax.distributed.initialize(
            f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
        )

    import numpy as np

    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.synthetic import SyntheticDataset
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer

    world = jax.device_count()
    if mode == "binslice":
        return binslice_main(pid, nproc, world, outfile)
    pooled = mode == "pooled"
    soak = mode == "soak"
    md = mode == "md"
    # adagrad_master: adagrad + the master-resident accumulator store,
    # row-sharded with the masters — evicted state writes back host-locally
    # to owned rows and resume values ride the window exchange's accs lane
    # (parallel/multihost.py), so 2x2 must stay aligned with the 1x4 run
    # whose store is unsharded and gathered directly
    adagrad = mode in ("adagrad", "adagrad_master")
    blockco = mode == "blockco"
    steps = 16 if mode == "one_window" else (200 if soak else 24)
    lookahead = steps + 4 if mode == "one_window" else (6 if soak else 4)
    cfg = Config(
        arch_sparse_feature_size=8,
        # resume: fully-resident geometry (128 cache rows/table >= every
        # table) — bit-exact resume is the contract only when no miss-row
        # gather races an eviction writeback, same as the single-host pin
        # (test_trainer_e2e.py::test_midstream_resume_equals_uninterrupted)
        arch_embedding_size="60-40-50" if mode == "resume" else "300-500-200",
        arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1",
        mini_batch_size=8 * world,
        world_size=world,
        cache_size=32,
        num_ways=4,
        loss_function="bce",
        lookahead=lookahead,
        print_freq=4,
        round_targets=True,
        num_indices_per_lookup=3 if pooled else 1,
        num_indices_per_lookup_fixed=not pooled,
        numpy_rand_seed=7,
        master_init="virtual",  # single-proc baseline matches sharded masters
        batch_fifo_size=4,
        # multi_window also exercises scan blocks across hosts: block caps
        # are pure functions of shared state, so every host runs identical
        # block sizes and the in-scan collectives stay aligned
        scan_steps=(
            3 if mode in ("multi_window", "noprestage", "resume", "blockco")
            else (5 if mode == "soak" else 1)
        ),
        # noprestage: multi_window with the main-thread window prefetch
        # (trainer._prefetch_next_window) disabled — the parent pins the
        # boundary-time and hoisted paths to the same trajectory
        refill_prestage=mode != "noprestage",
        # soak: every round-2/3 feature at once — scan blocks, insert-delta
        # refill (agg freq 3 divides lookahead 6 -> trajectory-equal),
        # eviction-heavy geometry, per-window negotiated miss bucket, and
        # the hot-tier update (host-identical hot lists + cold buckets from
        # the shadow stats must keep the cross-host trajectory aligned)
        refill_broadcast="delta" if mode == "soak" else "strict",
        table_agg_freq=3 if mode == "soak" else 6,
        # soak also runs MID-TRAIN eval cadences: the eval collectives
        # (row exchange + one-psum metrics) interleave with refills, agg
        # steps AND the prestage hoist's allgather — every host must issue
        # the identical sequence or the cross-topology pins below diverge
        test_freq=60 if soak else -1,
        hot_tier_rows=16 if soak else 0,
        # soak + pooled also run the UNPACKED wires (round-3 fast-host-link
        # mode): raw int32 ranks / plain int32 slots must stay host-symmetric
        # blockco: the block-coalesced sparse update across hosts — the
        # per-block union bucket is negotiated with one allgather-max on
        # the main thread (trainer._build_block_union), so 2x2 must stay
        # aligned with 1x4 and both must match the per-step trajectory up
        # to float reassociation. Requires the unpacked dedup wire;
        # block_coalesced_update='auto' (the default) resolves ON here.
        pack_wire=not (soak or pooled or blockco),
        # pooled also runs the SORTED unpacked wire across hosts: the
        # argsort permutation is a pure function of the (host-identical)
        # probe metadata, so 2x2 must stay aligned with 1x4
        sorted_dedup_wire=pooled,
        # md: the cached mixed-dimension path across hosts (compact sharded
        # masters sliced from the procedural block -> values AND projections
        # are host-count-invariant, so 2x2 must match 1x4)
        md_flag=md,
        md_temperature=1.0 if md else 0.3,
        # adagrad: cache-resident row-wise state across hosts — the accum
        # union-aggregate and refill insert-reset must keep 2x2 == 1x4.
        # eps=1e-2 damps 1/sqrt(acc)'s amplification of psum
        # reduction-order noise (at eps=1e-10 a 2e-8 first-step difference
        # compounds to ~1% by step 24 in BOTH orderings — numerically
        # expected, useless as a cross-topology pin)
        optimizer="adagrad" if adagrad else "sgd",
        adagrad_master_state=mode == "adagrad_master",
        dedup_lookups="on" if (adagrad or blockco) else "auto",
        adagrad_eps=1e-2,
    )
    cfg.finalize()

    common = dict(
        m_den=13,
        ln_emb=cfg.ln_emb,
        num_indices_per_lookup=3 if pooled else 1,
        num_indices_per_lookup_fixed=not pooled,
        round_targets=True,
        data_generation="random",
    )
    train = SyntheticDataset(
        data_size=cfg.mini_batch_size * (steps + 2),
        mini_batch_size=cfg.mini_batch_size,
        num_batches=steps + 2,
        seed=11,
        **common,
    )
    test = SyntheticDataset(
        data_size=cfg.mini_batch_size * 2,
        mini_batch_size=cfg.mini_batch_size,
        num_batches=2,
        seed=12,
        **common,
    )

    losses = []

    def _state(tr):
        cache = np.concatenate(
            [np.asarray(s.data) for s in tr.cache.addressable_shards]
        )
        leaves = jax.tree_util.tree_leaves(tr.params)
        # params are replicated: any addressable shard carries the value
        return cache, [
            np.asarray(l.addressable_shards[0].data) for l in leaves
        ]

    if mode == "resume":
        # multi-host mid-window checkpoint/resume (single-host pinned in
        # tests/test_trainer_e2e.py::test_midstream_resume_equals_...):
        # final cache + dense params must be bit-identical to the
        # uninterrupted run, with the mh refill prestage live throughout
        # SHARED across hosts: per-host files carry .h{pid} tags; host 0
        # writes the replica-identical pieces; save_checkpoint's multihost
        # barrier orders every host's writes before any host returns
        ckpt = os.path.join(os.path.dirname(outfile), f"ckpt_{nproc}")
        base = CachedDlrmTrainer(cfg, train, test)
        try:
            base.train(max_steps=steps, log_fn=lambda s: None)
            base_cache, base_params = _state(base)
        finally:
            base.close()
        part = CachedDlrmTrainer(cfg, train, test)
        try:
            part.train(max_steps=14, log_fn=lambda s: None)  # mid-window
            part.save_checkpoint(ckpt)
        finally:
            part.close()
        trainer = CachedDlrmTrainer(cfg, train, test)
        try:
            trainer.load_checkpoint(ckpt)
            m = trainer.train(max_steps=steps, log_fn=lambda s: None)
            res_cache, res_params = _state(trainer)
            assert np.array_equal(base_cache, res_cache), (
                "resumed cache diverged from the uninterrupted run"
            )
            for b, r in zip(base_params, res_params):
                assert np.array_equal(b, r), "resumed dense params diverged"
            losses.append(float(np.abs(res_cache).sum()))  # cross-host pin
            acc, auc = trainer.evaluate(log_fn=lambda s: None)
        finally:
            trainer.close()
    else:
        trainer = CachedDlrmTrainer(cfg, train, test)

        def log(line):
            if trainer.last_window is not None:
                losses.append(float(trainer.last_window["loss"]))

        try:
            m = trainer.train(max_steps=steps, log_fn=log)
            if blockco:
                # guard against a silent fallback: the coalesced step
                # variant must actually have compiled and dispatched
                assert any(k[3] for k in trainer._step_cache), (
                    "blockco mode ran but no coalesced block dispatched"
                )
            acc, auc = trainer.evaluate(log_fn=lambda s: None)
        finally:
            trainer.close()

    if trainer.multihost:
        # negotiated eval miss bucket (trainer._assemble): the staged
        # shape must track the real global miss counts, not
        # the T*aux_capacity worst case
        from cdlrm_tpu.utils.padding import pow2_bucket

        assert trainer._eval_bucket_log, "eval ran but no bucket negotiated"
        for k, worst in trainer._eval_bucket_log:
            assert worst <= k <= max(
                pow2_bucket(worst), 64
            ), (k, worst)

    result = {
        "pid": pid,
        "nproc": nproc,
        "world": world,
        "losses": losses,
        "acc": float(acc),
        "auc": float(auc) if not np.isnan(auc) else None,
        "hit_rate": m.hit_rate,
        "rows_written": trainer.eviction_manager.rows_written,
        "multihost": trainer.multihost,
        "mh_prefetches": trainer.mh_prefetches,
        # buckets must be identical across hosts (compiled global shapes);
        # the parent asserts cross-process equality
        "eval_buckets": [list(kv) for kv in trainer._eval_bucket_log],
        # adagrad_master: per-host owned-support population — the parent
        # asserts state actually round-tripped (> 0 somewhere)
        "acc_store_nonzero": (
            None if trainer._acc_master is None else
            int(sum(int(np.count_nonzero(a))
                    for a in trainer._acc_master.accs))
        ),
    }
    with open(outfile, "w") as f:
        json.dump(result, f)
    print(f"worker {pid}/{nproc} OK", flush=True)


def binslice_main(pid, nproc, world, outfile):
    """config.data_host_slice e2e: a bin-backed training where each host
    READS only its replicas' row range must be trajectory-identical to the
    full-read run — catches any code path that would consume the
    zero-filled out-of-slice rows. Fully-resident geometry (same reasoning
    as the resume scenario). Every worker fabricates the identical bin
    bytes from the same seed; no file sharing needed."""
    import numpy as np

    import jax

    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.criteo import SPA_FEA, CriteoBinDataset
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer

    steps, b = 16, 8 * world
    rows = b * (steps + 2)
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, (rows, 1))
    x_int = rng.integers(0, 100, (rows, 13))
    x_cat = rng.integers(0, 50, (rows, SPA_FEA))
    d = os.path.dirname(outfile)
    bin_path = os.path.join(d, f"binslice_{pid}.bin")
    counts_path = os.path.join(d, f"binslice_counts_{pid}.npz")
    with open(bin_path, "wb") as f:
        f.write(np.concatenate([y, x_int, x_cat], axis=1)
                .astype(np.int32).tobytes())
    np.savez(counts_path, counts=np.full(SPA_FEA, 50, np.int64))

    cfg_kw = dict(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8",
        arch_mlp_top="8-1", mini_batch_size=b, world_size=world,
        cache_size=32, num_ways=4, loss_function="bce", lookahead=4,
        print_freq=4, round_targets=True, numpy_rand_seed=7,
        master_init="virtual", batch_fifo_size=4, scan_steps=3,
    )

    def run(host_rows):
        cfg = Config(**cfg_kw)
        train = CriteoBinDataset(bin_path, counts_path, batch_size=b,
                                 host_rows=host_rows)
        test = CriteoBinDataset(bin_path, counts_path, batch_size=b)
        cfg.finalize(ln_emb=train.ln_emb, m_den=train.m_den)
        tr = CachedDlrmTrainer(cfg, train, test)
        try:
            tr.train(max_steps=steps, log_fn=lambda s: None)
            cache = np.concatenate(
                [np.asarray(s.data) for s in tr.cache.addressable_shards]
            )
            leaves = [
                np.asarray(l.addressable_shards[0].data)
                for l in jax.tree_util.tree_leaves(tr.params)
            ]
            acc, auc = tr.evaluate(log_fn=lambda s: None)
            hit = tr.metrics.hit_rate
        finally:
            tr.close()
        return cache, leaves, float(acc), hit

    full_cache, full_params, full_acc, _ = run(None)
    sl = (pid * b // nproc, (pid + 1) * b // nproc)
    cache, params, acc, hit = run(sl)
    assert np.array_equal(full_cache, cache), (
        "host-sliced run diverged from the full-read run"
    )
    for a, bb in zip(full_params, params):
        assert np.array_equal(a, bb), "dense params diverged under host_rows"
    assert acc == full_acc

    with open(outfile, "w") as f:
        json.dump({"pid": pid, "nproc": nproc, "world": world,
                   "losses": [float(np.abs(cache).sum())],
                   "acc": acc, "auc": None, "hit_rate": hit,
                   "rows_written": 0, "multihost": nproc > 1,
                   "mh_prefetches": 0, "eval_buckets": []}, f)
    print(f"worker {pid}/{nproc} OK", flush=True)


if __name__ == "__main__":
    main()
