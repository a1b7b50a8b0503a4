"""On-chip A/B: serial vs pipelined serving path, at ~full residency so the
mechanism (assembly/forward overlap) is visible rather than the miss-row
H2D.

Reference anchor: the strictly-serial rank-0 test loop this improves on,
/root/reference/main_no_ddp.py:479-494.

Needs a GPU; SERVINGAB_CPU=1 smokes the harness on the 8-device CPU
mesh."""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(m):
    print(f"[evalab] {m}", file=sys.stderr, flush=True)


def main():
    import jax
    from cdlrm_tpu.utils.device import enable_compile_cache, require_gpu

    if os.environ.get("SERVINGAB_CPU"):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    else:
        require_gpu("bench_serving_ab.py (SERVINGAB_CPU=1 for the smoke)")
    enable_compile_cache()

    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.synthetic import Batch
    from cdlrm_tpu.train.trainer import CachedDlrmTrainer, _pad_batch

    if os.environ.get("SERVINGAB_CPU"):
        num_tables, dim, batch = 4, 16, 256
        table_rows, cache_size, ways = 3_000, 512, 4
        arch_bot, arch_top = "13-32-16", "32-16-1"
        world = 8
    else:
        num_tables, dim, batch = 26, 128, 4096
        table_rows, cache_size, ways = 250_000, 16_384, 8
        arch_bot, arch_top = "13-512-256-128", "512-256-1"
        world = 1
    ln_emb = np.full(num_tables, table_rows, dtype=np.int64)
    cfg = Config(
        arch_sparse_feature_size=dim, arch_mlp_bot=arch_bot,
        arch_mlp_top=arch_top, mini_batch_size=batch, world_size=world,
        cache_size=cache_size, num_ways=ways, loss_function="bce",
        lookahead=40, table_agg_freq=1_000_000, print_freq=1_000_000,
        round_targets=True, compute_dtype="bfloat16", master_init="virtual",
        scan_steps=10, batch_fifo_size=4,
    )
    cfg.finalize(ln_emb=ln_emb)

    class DS:
        m_den = 13
        ln_emb_ = ln_emb

        def __init__(self, n, seed):
            self.ln_emb = ln_emb
            self.n, self.seed = n, seed

        def __len__(self):
            return self.n

        def batches(self):
            rng = np.random.Generator(np.random.SFC64(self.seed))
            for _ in range(self.n):
                x = rng.random((batch, 13), dtype=np.float32)
                u = rng.random((num_tables, batch), dtype=np.float32)
                idx = np.exp(u * np.log(table_rows)).astype(np.int64) - 1
                np.minimum(idx, table_rows - 1, out=idx)
                y = np.round(rng.random((batch, 1), dtype=np.float32))
                yield Batch(x, idx, None, y)

    # SAME seed for train and eval: the eval stream's ids are (statistically)
    # the train window's ids -> hit rate ~1, no miss H2D wall
    tr = CachedDlrmTrainer(cfg, DS(36, seed=0), DS(24, seed=0))
    log("trainer built; filling cache (one window)")
    tr.train(max_steps=12, log_fn=lambda s: None)

    tb_loc = cfg.test_mini_batch_size // tr.ndev

    def serial_eval(nb):
        """Round-3 semantics: assemble -> forward -> materialize, strictly
        serial per batch."""
        for i, b in enumerate(tr.test_dataset.batches()):
            if i >= nb:
                break
            n = b.x.shape[0]
            padded = _pad_batch(b, tb_loc * tr.ndev)
            probed = tr._probe_eval(padded, tb_loc)
            inputs = tr._stage_eval(probed, tb_loc)
            tr.cache, scores = tr.eval_step(tr.params, tr.cache, *inputs)
            _ = np.asarray(scores)[:n]

    nb = 20
    # compile both paths
    serial_eval(2)
    tr.evaluate(max_batches=2, log_fn=lambda s: None)

    t0 = time.perf_counter()
    serial_eval(nb)
    dt_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.evaluate(max_batches=nb, log_fn=lambda s: None)
    dt_pipe = time.perf_counter() - t0
    # order-swap repeat to cancel drift
    t0 = time.perf_counter()
    tr.evaluate(max_batches=nb, log_fn=lambda s: None)
    dt_pipe2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial_eval(nb)
    dt_serial2 = time.perf_counter() - t0

    eps = lambda dt: round(nb * batch / dt, 1)
    out = {
        "metric": "serving_pipeline_ab",
        "eval_hit_rate": round(tr.metrics.eval_hit_rate, 4),
        "serial_examples_per_sec": eps((dt_serial + dt_serial2) / 2),
        "pipelined_examples_per_sec": eps((dt_pipe + dt_pipe2) / 2),
        "speedup": round((dt_serial + dt_serial2) / (dt_pipe + dt_pipe2), 3),
        "batches": nb, "batch": batch,
    }
    tr.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
