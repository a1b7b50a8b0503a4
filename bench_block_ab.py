"""Block-coalesced sparse update vs per-step dedup scatter — the kernel-level
A/B on realistic index streams.

Both formulations pay the same N-row scatter into a small destination each
step (the AD transpose of the dedup expand). They differ in the EXTRA work:
  A (current dedup wire): per step, scatter U_step unique summed rows into
    the 3.5M-row cache.
  B (block-coalesced):    per step, gather U_step rows from a pending
    accumulator + dense add (the base+pending effective-weight read);
    per BLOCK, one scatter of U_block rows into the cache + re-zero pending.
Exact SGD semantics in both (B reads w_eff = base - lr*pending).

Measured as 10-step chained programs ending in a real D2H. Streams: loguniform (headline) and zipf(1.2) over 26 tables x
250k ids at batch 4096 (N = 106,496 lookups/step).

Geometry is env-overridable (BLOCKAB_TABLES/IDS/BATCH/CACHE_ROWS, plus
BLOCKAB_CPU=1 to smoke on the CPU; otherwise it needs a GPU) so the harness
can be validated on the CPU mesh before spending chip time.

Reference anchor: sparse-update semantics the formulations must preserve,
/root/reference/main_no_ddp.py:374-376,413 (EmbeddingBag sparse grads applied
per step into the cache block).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T = int(os.environ.get("BLOCKAB_TABLES", "26"))
B = int(os.environ.get("BLOCKAB_BATCH", "4096"))
R = int(os.environ.get("BLOCKAB_IDS", "250000"))
CACHE_ROWS = int(os.environ.get("BLOCKAB_CACHE_ROWS", str(3_520_000)))
D = 128
STEPS = 10


def stream_indices(kind, steps, rng):
    out = []
    for _ in range(steps):
        if kind == "loguniform":
            u = rng.random((T, B), dtype=np.float32)
            ls = (np.exp(u * np.log(R)).astype(np.int64) - 1) % R
        else:
            a = 1.2
            u = rng.random((T, B), dtype=np.float64)
            v = np.minimum(np.power(1.0 - u, -1.0 / (a - 1.0)), 9e18)
            ls = (v.astype(np.int64) - 1) % R
        out.append(ls.astype(np.int64))
    return out


def main():
    import jax
    import jax.numpy as jnp

    from cdlrm_tpu.utils.device import enable_compile_cache, require_gpu

    if os.environ.get("BLOCKAB_CPU"):
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu("bench_block_ab.py (BLOCKAB_CPU=1 for the smoke)")
    enable_compile_cache()

    N = T * B

    rng = np.random.Generator(np.random.SFC64(7))
    grads = jnp.asarray(rng.random((STEPS, N, D), np.float32) - 0.5)

    for kind in ("loguniform", "zipf12"):
        ls = stream_indices(kind, STEPS, rng)
        # flatten to cache-row space: table t owns rows [t*135k, ...)
        flat = [
            (l + (np.arange(T, dtype=np.int64) * (CACHE_ROWS // T))[:, None])
            .reshape(-1) for l in ls
        ]
        # per-step uniques + first-seen ranks (the dedup wire's host output)
        step_u, step_ranks, step_uniq = [], [], []
        for f in flat:
            uniq, ranks = np.unique(f, return_inverse=True)
            step_u.append(len(uniq))
            step_ranks.append(ranks.astype(np.int32))
            step_uniq.append(uniq.astype(np.int32))
        # block union + per-step ranks against it (formulation B's host output)
        bu = np.unique(np.concatenate(flat))
        U_block = len(bu)
        blk_ranks = [np.searchsorted(bu, f).astype(np.int32) for f in flat]
        bu32 = bu.astype(np.int32)
        # block ranks of each STEP's unique rows (for B's pending-row
        # gather): real scattered indices, so XLA cannot reduce the gather
        # to a contiguous slice and under-charge formulation B
        step_uniq_blk = [
            np.searchsorted(bu, u).astype(np.int32) for u in step_uniq]

        def pow2(n):
            p = 1
            while p < n:
                p *= 2
            return p

        u_bucket = pow2(max(step_u))  # monotone pow2 bucket, as in the trainer
        p_rows = pow2(U_block)

        ranks_a = jnp.asarray(np.stack([
            np.pad(r, (0, 0)) for r in step_ranks]))
        uniq_a = jnp.asarray(np.stack([
            np.pad(u, (0, u_bucket - len(u)), constant_values=CACHE_ROWS - 1)
            for u in step_uniq]))
        nvalid = jnp.asarray(np.array(step_u, np.int32))
        ranks_b = jnp.asarray(np.stack(blk_ranks))
        uniq_blk = jnp.asarray(np.stack([
            np.pad(u, (0, u_bucket - len(u)), constant_values=0)
            for u in step_uniq_blk]))
        uniq_b = jnp.asarray(np.pad(
            bu32, (0, p_rows - U_block), constant_values=CACHE_ROWS - 1))

        # All large operands are explicit jit ARGUMENTS (scan xs), never
        # closure captures: a captured concrete array lowers as an HLO
        # constant baked into the executable at this geometry.

        # ---- A: per-step segsum into u_bucket + per-step cache scatter ----
        def step_a(cache, x):
            r, u, g = x
            seg = jnp.zeros((u_bucket, D), jnp.float32).at[r].add(g)
            # mask padded bucket rows to the trash row (uniq_a padding)
            cache = cache.at[u].add(seg)
            return cache, jnp.float32(0)

        # ---- B: per-step segsum into pending + gather/add; 1 cache scatter --
        def step_b(carry, x):
            cache, pend = carry
            rb, ua, ublk, g = x
            pend = pend.at[rb].add(g)
            # effective-weight read: gather the step's touched rows from the
            # cache AND the pending accumulator (w_eff = base - lr * pend)
            eff = cache[ua] - 0.1 * pend[ublk]
            return (cache, pend), eff.sum()

        import functools

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run_a(cache, ranks, uniq, gr):
            cache, _ = jax.lax.scan(step_a, cache, (ranks, uniq, gr))
            return cache

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def run_b(cache, pend, rb, ua, ublk, gr, ub_rows):
            (cache, pend), s = jax.lax.scan(
                step_b, (cache, pend), (rb, ua, ublk, gr))
            cache = cache.at[ub_rows].add(pend)
            pend = jnp.zeros_like(pend)
            return cache, pend, s.sum()

        cache = jnp.zeros((CACHE_ROWS, D), jnp.float32)
        cache = run_a(cache, ranks_a, uniq_a, grads)
        cache = run_a(cache, ranks_a, uniq_a, grads)
        _ = float(cache[0, 0])
        t0 = time.perf_counter()
        REPS = 5
        for _ in range(REPS):
            cache = run_a(cache, ranks_a, uniq_a, grads)
        _ = float(cache[0, 0])
        a_ms = (time.perf_counter() - t0) / (REPS * STEPS) * 1e3

        del cache
        cache = jnp.zeros((CACHE_ROWS, D), jnp.float32)
        pend = jnp.zeros((p_rows, D), jnp.float32)
        cache, pend, _ = run_b(cache, pend, ranks_b, uniq_a, uniq_blk, grads,
                               uniq_b)
        cache, pend, s = run_b(cache, pend, ranks_b, uniq_a, uniq_blk, grads,
                               uniq_b)
        _ = float(s)
        t0 = time.perf_counter()
        for _ in range(REPS):
            cache, pend, s = run_b(cache, pend, ranks_b, uniq_a, uniq_blk,
                                   grads, uniq_b)
        _ = float(s)
        b_ms = (time.perf_counter() - t0) / (REPS * STEPS) * 1e3
        del cache, pend

        print(json.dumps({
            "stream": kind, "N": N, "U_step_max": int(max(step_u)),
            "u_bucket": u_bucket, "U_block": int(U_block), "p_rows": p_rows,
            "per_step_ms_A_dedup": round(a_ms, 2),
            "per_step_ms_B_coalesced": round(b_ms, 2),
            "B_over_A": round(b_ms / a_ms, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
