#!/usr/bin/env python
"""Where the block-coalesced device step goes.

Times each component of the block-coalesced dedup train step IN ISOLATION
at the exact headline shapes (26x250k tables, dim 128, batch 4096 ->
N=106,496 lookups, U_step 64k bucket, flat cache 3,519,985 x 128 f32
= 1.8 GB, block-union pending buffer 524,288 x 128 = 268 MB), for
comparison against bench.py's end-to-end block_step_ms_per_iter.
Components:

  gather_uniq    cache[uniq] 64k rows from the 1.8 GB cache (XLA take)
  expand_take    rows_exp = uniq_rows[inv] (106k from 64k)
  pend_scatter   d_eff -> pending.at[blk_rank].add (106k DUP rows into
                 the 268 MB pending buffer; the coalesced path's
                 per-step replacement for the cache scatter)
  cache_scatter  the per-step path's 64k-row scatter-add into 1.8 GB
                 (what coalescing amortizes over the block)
  flush_scatter  the once-per-block 300k-distinct-row flush into 1.8 GB
  dense_fwdbwd   bottom/top MLP + dot interaction fwd+bwd at batch 4096
                 bf16, embedding rows as a fixed input (value_and_grad)

All timings are wall time over N chained executions ending in a real scalar
D2H. Emits one JSON line per component plus a summary line with the
accounted fraction. Needs a GPU; BREAKDOWN_CPU=1 runs tiny shapes on the CPU
backend (bitrot smoke; never numbers to report).

Reference anchor for what these components correspond to in the original:
EmbeddingBag forward/backward + sparse SGD apply,
/root/reference/model_no_ddp.py:200-202 and main_no_ddp.py:374-376.
"""

import json
import os
import sys
import time


def log(msg):
    print(f"[breakdown] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    cpu_ok = bool(os.environ.get("BREAKDOWN_CPU"))
    if cpu_ok:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from cdlrm_tpu.utils.device import enable_compile_cache, require_gpu

    enable_compile_cache()
    if not cpu_ok:
        require_gpu("bench_step_breakdown.py (BREAKDOWN_CPU=1 for the smoke)")
        T, B, D = 26, 4096, 128
        R = 3_519_985          # flat cache rows (bench.py geometry)
        UB = 65_536            # per-step unique bucket
        NV = 46_600            # realistic valid uniques (loguniform)
        P = 524_288            # block-union pending rows
        PV = 300_000           # realistic block-union size
        BOT, TOP = (13, 512, 256, 128), (512, 256, 1)
        iters = 30
    else:
        T, B, D = 4, 128, 32
        R, UB, NV, P, PV = 20_000, 1024, 700, 4096, 2000
        BOT, TOP = (13, 64, 32), (64, 32, 1)
        iters = 5
    N = T * B

    rng = np.random.default_rng(7)
    results = []

    def timed(name, fn, *args, note=""):
        """The device queue is FIFO, so the scalar D2H on the LAST output
        walls every queued execution."""
        out = fn(*args)  # compile + warm
        _ = float(jnp.sum(out[:1]) if out.ndim else out)
        t0 = time.perf_counter()
        o = None
        for _ in range(iters):
            o = fn(*args)
        _ = float(jnp.sum(o[:1]) if o.ndim else o)
        dt = 1e3 * (time.perf_counter() - t0) / iters
        rec = {"component": name, "ms": round(dt, 3), "note": note}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        return dt

    # ---- operands (allocated once; donation-free timing reuses inputs) ----
    log(f"allocating: cache {R}x{D} f32 "
        f"({R * D * 4 / 1e9:.2f} GB), pending {P}x{D}")
    cache = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    # padding beyond nvalid is spread over DISTINCT rows (the block
    # flush's `spread` trick; the per-step path trash-pads)
    uniq = jnp.asarray(
        np.concatenate([
            rng.choice(R - 1, NV, replace=False),
            np.arange(UB - NV, dtype=np.int64) % (R - 1),
        ]).astype(np.int32)
    )
    inv = jnp.asarray(rng.integers(0, NV, N).astype(np.int32))
    d_rows = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    blk_rank = jnp.asarray(rng.integers(0, PV, N).astype(np.int32))
    pend = jnp.zeros((P, D), jnp.float32)
    blk_slots = jnp.asarray(
        np.concatenate([
            np.sort(rng.choice(R - 1, PV, replace=False)),
            np.arange(P - PV, dtype=np.int64) % (R - 1),  # spread pad
        ]).astype(np.int32)
    )
    pend_full = jnp.asarray(rng.normal(size=(P, D)).astype(np.float32))
    delta = jnp.asarray(rng.normal(size=(UB, D)).astype(np.float32))
    jax.block_until_ready((cache, pend_full))

    # ---- components ----
    gather = jax.jit(lambda c, u: jnp.take(c, u, axis=0))
    timed("gather_uniq", gather, cache, uniq,
          note=f"{UB} rows from {R}x{D} f32")

    expand = jax.jit(lambda r, i: jnp.take(r, i, axis=0))
    uniq_rows = gather(cache, uniq)
    jax.block_until_ready(uniq_rows)
    timed("expand_take", expand, uniq_rows, inv,
          note=f"{N} from {UB} rows")

    pscat = jax.jit(lambda p, r, g: p.at[r].add(g))
    timed("pend_scatter", pscat, pend, blk_rank, d_rows,
          note=f"{N} DUP rows into {P}x{D}")

    cscat = jax.jit(lambda c, s, g: c.at[s].add(g))
    timed("cache_scatter", cscat, cache, uniq, delta,
          note=f"{UB}-bucket ({NV} valid) into {R}x{D}")

    timed("flush_scatter", cscat, cache, blk_slots, pend_full,
          note=f"{P}-bucket ({PV} valid) into {R}x{D}, once per block")

    # dense fwd+bwd: embedding rows enter as data (the cached step's rows
    # come from the gather above); dot interaction + MLPs, bf16 compute
    def init_mlp(sizes, key):
        ws = []
        for i in range(len(sizes) - 1):
            key, k1 = jax.random.split(key)
            ws.append((
                jax.random.normal(k1, (sizes[i], sizes[i + 1]),
                                  jnp.float32) * 0.05,
                jnp.zeros((sizes[i + 1],), jnp.float32),
            ))
        return ws, key

    key = jax.random.PRNGKey(3)
    bot, key = init_mlp(BOT, key)
    ni = 1 + T  # dense + T embedding vectors
    n_int = BOT[-1] + ni * (ni - 1) // 2
    # reference arch_mlp_top lists hidden->out sizes; input = num_int
    top, key = init_mlp((n_int,) + TOP, key)
    x = jnp.asarray(rng.normal(size=(B, BOT[0])).astype(np.float32))
    rows = jnp.asarray(rng.normal(size=(T, B, D)).astype(np.float32))
    y = jnp.asarray((rng.random((B, 1)) < 0.5).astype(np.float32))

    def fwd(params, x, rows, y):
        bot_w, top_w = params
        h = x.astype(jnp.bfloat16)
        for w, b in bot_w:
            h = jax.nn.relu(h @ w.astype(jnp.bfloat16) + b.astype(jnp.bfloat16))
        feats = jnp.concatenate(
            [h[:, None, :], jnp.transpose(rows, (1, 0, 2)).astype(jnp.bfloat16)],
            axis=1,
        )  # [B, 1+T, D]
        z = jnp.einsum("bid,bjd->bij", feats, feats)
        iu, ju = jnp.triu_indices(ni, k=1)
        inter = z[:, iu, ju]
        h = jnp.concatenate([h, inter], axis=1)
        for k, (w, b) in enumerate(top_w):
            h = h @ w.astype(jnp.bfloat16) + b.astype(jnp.bfloat16)
            if k < len(top_w) - 1:
                h = jax.nn.relu(h)
        p = jax.nn.sigmoid(h.astype(jnp.float32))
        eps = 1e-7
        return -jnp.mean(y * jnp.log(p + eps) + (1 - y) * jnp.log1p(eps - p))

    grad_fn = jax.jit(jax.value_and_grad(fwd, argnums=(0, 2)))

    def dense_step(params, x, rows, y):
        loss, (gp, grows) = grad_fn(params, x, rows, y)
        return loss

    timed("dense_fwdbwd", dense_step, (bot, top), x, rows, y,
          note=f"bot {BOT} top {TOP} + dot interaction, batch {B} bf16, "
               "value_and_grad wrt params AND rows")

    comp = {r["component"]: r["ms"] for r in results}
    per_step_coalesced = (
        comp["gather_uniq"] + comp["expand_take"] + comp["pend_scatter"]
        + comp["dense_fwdbwd"]
    )
    per_step_perstep = (
        comp["gather_uniq"] + comp["expand_take"] + comp["cache_scatter"]
        + comp["dense_fwdbwd"]
    )
    summary = {
        "metric": "step_breakdown",
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "sum_components_coalesced_ms": round(per_step_coalesced, 3),
        "flush_amortized_ms_at_block10": round(comp["flush_scatter"] / 10, 3),
        "sum_components_perstep_ms": round(per_step_perstep, 3),
        "components": comp,
        "note": (
            "isolated-kernel sums; the fused step beats the sum where XLA "
            "overlaps gather/scatter with matmul work — compare against "
            "bench.py block_step_ms_per_iter"
        ),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
