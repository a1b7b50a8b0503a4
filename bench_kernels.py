"""Kernel microbenchmarks vs the device-memory roofline (SURVEY.md §7 step 7).

Times what XLA makes of the cached step's plain sparse operations at the
headline shapes (26 tables x 4096 per-card batch, dim 128, the flat cache
of bench.py's geometry: 3,519,985 rows = 1.8 GB) against the card's published
HBM bandwidth (cdlrm_tpu/utils/device.py DEVICE_PEAKS, keyed by device_kind):

  lookup_gather   cache[slots], 106,496 rows (the plain step's lookup)
  uniq_scatter_add  cache.at[uniq].add(delta), 65,536 DISTINCT rows (the
                  dedup wire's sparse update)
  insert_set      cache.at[ins].set(rows), 65,536 distinct rows (the refill
                  insert / aux staging)

plus the dot interaction and the sparse-update formulations the step
chooses between. Each sparse row is also checked against numpy at its full
width. Needs a GPU; KERNELS_CPU=1 runs shrunken shapes on the CPU (bitrot
smoke; never numbers to report). Prints one JSON line per kernel.
"""

import json
import os
import sys
import time

import numpy as np

# headline shapes (bench.py HEADLINE_GEOMETRY): flat cache rows =
# 26 tables x (16,411 sets x 8 ways + 4096 aux rows) + 1 trash row
HEADLINE = dict(rows=3_519_985, dim=128, lookups=26 * 4096, uniq=65_536,
                insert=65_536)
SMOKE_SHAPES = dict(rows=20_000, dim=128, lookups=2048, uniq=1024,
                    insert=512)


def log(msg):
    print(f"[bench_kernels] {msg}", file=sys.stderr, flush=True)


def sparse_bytes(kind: str, n: int, d: int) -> int:
    """Device-memory bytes the operation needs at f32: a gather reads n rows
    and writes n; a distinct scatter-add reads the delta and the n
    destination rows and writes them back; a set reads n rows and writes
    n (index reads are <1% and not counted)."""
    per = {"gather": 2, "scatter_add": 3, "set": 2}[kind]
    return per * n * d * 4


def time_chain(fn, state, inputs, reps, consts=None):
    """Per-iteration seconds of ``fn(state, x, consts)`` chained over
    ``inputs`` (a stacked [K, ...] pytree) inside one jitted scan, so
    dispatch amortizes over K. The state is donated (updated in place, no
    copy per call); ``consts`` are read-only arguments (a closed-over array
    would be baked into the executable as a constant). Returns the median
    over ``reps`` timed calls (after one compile call) and the final
    state."""
    import jax

    def run(st, xs, cs):
        def body(c, x):
            return fn(c, x, cs), None
        out, _ = jax.lax.scan(body, st, xs)
        return out

    run = jax.jit(run, donate_argnums=(0,))
    state = jax.block_until_ready(run(state, inputs, consts))
    k = jax.tree_util.tree_leaves(inputs)[0].shape[0]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state, inputs, consts))
        times.append((time.perf_counter() - t0) / k)
    return float(np.median(times)), state


def time_sparse_kernels(smoke: bool = False, peak_gbps=None, seed: int = 0):
    """The three sparse rows at real width: each timed, checked against
    numpy, and set against ``peak_gbps`` (None -> no roofline share, the
    CPU smoke). Returns a list of result dicts; raises AssertionError when
    a result disagrees with numpy."""
    import jax
    import jax.numpy as jnp

    sh = SMOKE_SHAPES if smoke else HEADLINE
    r, d = sh["rows"], sh["dim"]
    chain, reps = (2, 2) if smoke else (20, 5)
    rng = np.random.Generator(np.random.SFC64(seed))
    key = jax.random.PRNGKey(seed)
    cache = jax.random.normal(key, (r, d), jnp.float32)
    cache_np = np.asarray(cache)
    results = []

    def record(name, kind, n, dt):
        nbytes = sparse_bytes(kind, n, d)
        rec = {"kernel": name, "us": round(dt * 1e6, 2), "rows": n,
               "bytes": nbytes, "gbps": round(nbytes / dt / 1e9, 1)}
        if peak_gbps is not None:
            rec["roofline_us"] = round(nbytes / (peak_gbps * 1e9) * 1e6, 2)
            rec["roofline_frac"] = round(nbytes / dt / 1e9 / peak_gbps, 3)
        results.append(rec)
        log(json.dumps(rec))

    # --- gather: K distinct slot sets; each iteration's slots depend on
    # the previous output, so no iteration is dead code ---
    n = sh["lookups"]
    slots = rng.integers(0, r - 1, (chain, n)).astype(np.int32)
    out = jnp.take(cache, jnp.asarray(slots[0]), axis=0)
    np.testing.assert_array_equal(np.asarray(out), cache_np[slots[0]])

    def gather(prev, s, c):
        dep = (prev[0, 0] > 1e30).astype(jnp.int32)  # always 0
        return jnp.take(c, s + dep, axis=0)

    dt, _ = time_chain(gather, out, jnp.asarray(slots), reps, consts=cache)
    record(f"lookup_gather/xla_{n}", "gather", n, dt)
    del out

    # --- distinct-row scatter-add (the dedup wire's contract) ---
    u = sh["uniq"]
    uniq = np.stack([rng.choice(r - 1, u, replace=False)
                     for _ in range(chain)]).astype(np.int32)
    delta = rng.standard_normal((chain, u, d), dtype=np.float32)
    got = np.asarray(
        jax.jit(lambda c, s, g: c.at[s].add(g)[s])(
            cache, jnp.asarray(uniq[0]), jnp.asarray(delta[0]))
    )
    # distinct rows: one f32 add per element -> bit-exact
    np.testing.assert_array_equal(got, cache_np[uniq[0]] + delta[0])

    def scatter_add(c, xs, _):
        s, g = xs
        return c.at[s].add(g)

    dt, cache = time_chain(
        scatter_add, cache, (jnp.asarray(uniq), jnp.asarray(delta)), reps)
    record(f"uniq_scatter_add/xla_{u}", "scatter_add", u, dt)

    # --- insert set (refill insert / aux staging: distinct rows) ---
    m = sh["insert"]
    ins = np.stack([rng.choice(r - 1, m, replace=False)
                    for _ in range(chain)]).astype(np.int32)
    rows = rng.standard_normal((chain, m, d), dtype=np.float32)
    got = np.asarray(
        jax.jit(lambda c, s, v: c.at[s].set(v)[s])(
            cache, jnp.asarray(ins[0]), jnp.asarray(rows[0]))
    )
    np.testing.assert_array_equal(got, rows[0])

    def insert(c, xs, _):
        s, v = xs
        return c.at[s].set(v)

    dt, cache = time_chain(
        insert, cache, (jnp.asarray(ins), jnp.asarray(rows)), reps)
    record(f"insert_set/xla_{m}", "set", m, dt)
    del cache
    return results


def main():
    import jax

    smoke = bool(os.environ.get("KERNELS_CPU"))
    if smoke:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cdlrm_tpu.utils.device import (
        device_peak, enable_compile_cache, require_gpu,
    )

    enable_compile_cache()
    peak = None
    if not smoke:
        require_gpu("bench_kernels.py (KERNELS_CPU=1 for the smoke)")
        peak = device_peak(jax.devices()[0].device_kind)
    rng = np.random.Generator(np.random.SFC64(0))
    results = time_sparse_kernels(
        smoke, None if peak is None else peak.hbm_gbps
    )
    d = 128
    CHAIN = 2 if smoke else 10

    # dot interaction at bench shape
    from cdlrm_tpu.models.dlrm import interact_features

    b, t = (64, 26) if smoke else (4096, 26)
    x = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    ly = jnp.asarray(rng.normal(size=(t, b, d)).astype(np.float32))

    @jax.jit
    def inter_chain(x, ly):
        # each round perturbs x by the previous round's scalar so XLA
        # cannot CSE the chain into one interaction
        def body(acc, _):
            z = interact_features(x + acc, ly, "dot", False, jnp.bfloat16)
            return jnp.sum(z).astype(jnp.float32) * 1e-30, None
        acc, _ = jax.lax.scan(body, jnp.float32(0), None, length=CHAIN)
        return acc

    _ = float(inter_chain(x, ly))
    inter_iters = 1 if smoke else 5
    t0 = time.perf_counter()
    for _ in range(inter_iters):
        _ = float(inter_chain(x, ly))
    dt = (time.perf_counter() - t0) / (inter_iters * CHAIN)
    flops = 2 * b * (t + 1) * (t + 1) * d
    rec = {"kernel": "dot_interaction/xla_bf16", "us": round(dt * 1e6, 1),
           "tflops": round(flops / dt / 1e12, 2)}
    if peak is not None:
        rec["peak_frac"] = round(flops / dt / 1e12 / peak.bf16_tflops, 4)
    results.append(rec)

    # --- sparse-update formulations: chained donated calls ending on a
    # scalar D2H ---
    def timeit_scatter(body, args, iters=2 if smoke else 10):
        from jax.sharding import PartitionSpec as P

        from cdlrm_tpu.parallel.mesh import DP_AXIS, make_dp_mesh

        mesh = make_dp_mesh(1)
        sm = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(DP_AXIS),) + tuple(P(None) for _ in args),
            out_specs=P(DP_AXIS), check_vma=False)
        f = jax.jit(sm, donate_argnums=(0,))
        c = jnp.zeros((R_CACHE, DIMS), jnp.float32)
        c = f(c, *args); c = f(c, *args); _ = float(c[0, 0])
        t0 = time.perf_counter()
        for _ in range(iters):
            c = f(c, *args)
        _ = float(c[0, 0])
        return (time.perf_counter() - t0) / iters

    R_CACHE, DIMS, N_UPD = (
        (80_000, 128, 26 * 64) if smoke else (3_520_000, 128, 26 * 4096)
    )
    UB = 1 << 10 if smoke else 1 << 16
    rngs = np.random.Generator(np.random.SFC64(0))
    u = rngs.random(N_UPD, dtype=np.float32)
    slots_np = np.minimum(
        np.exp(u * np.log(R_CACHE - 2)).astype(np.int64), R_CACHE - 2
    ).astype(np.int32)
    uniq_np = np.unique(slots_np)
    uniq_pad = np.full(UB, R_CACHE - 1, np.int32)
    uniq_pad[: uniq_np.size] = uniq_np
    ginv_np = np.searchsorted(uniq_np, slots_np).astype(np.int32)
    slots_d = jnp.asarray(slots_np)
    uniq_d = jnp.asarray(uniq_pad)
    ginv_d = jnp.asarray(ginv_np)
    grads = jnp.asarray(rngs.random((N_UPD, DIMS), np.float32))

    dt = timeit_scatter(lambda c, s, g: c.at[s].add(g), (slots_d, grads))
    results.append({"kernel": f"scatter_add/{N_UPD}_dup_rows",
                    "ms": round(dt * 1e3, 2),
                    "ns_per_update": round(dt * 1e9 / N_UPD, 1)})

    def seg(c, gi, uq, g):
        su = jnp.zeros((UB, DIMS), g.dtype).at[gi].add(g)
        return c.at[uq].add(su)

    dt = timeit_scatter(seg, (ginv_d, uniq_d, grads))
    results.append({"kernel": f"scatter_add/segsum_{UB}_unique",
                    "ms": round(dt * 1e3, 2),
                    "unique": int(uniq_np.size)})

    # --- destination-size sweep: per-row scatter-add cost into a small
    # pending buffer vs the full cache (the block-coalescing question) ---
    dests = (256, 1024) if smoke else (
        1024, 2048, 4096, 8192, 16384, 65536, 262144)
    for u_dest in dests:
        dest_slots = jnp.asarray((slots_np % (u_dest - 1)).astype(np.int32))

        def body(c, s, g, u=u_dest):
            pend = jnp.zeros((u, DIMS), jnp.float32).at[s].add(g)
            # consume pending via a 1-row add so XLA cannot DCE it
            return c.at[0:1].add(pend[:1])

        dt = timeit_scatter(body, (dest_slots, grads))
        results.append({
            "kernel": f"scatter_add/{N_UPD}_rows_into_{u_dest}_dest",
            "ms": round(dt * 1e3, 2),
            "ns_per_update": round(dt * 1e9 / N_UPD, 1),
        })

    # --- jnp.searchsorted: the default 'scan' method lowers to log-many
    # serial dependent gathers; 'sort' is one sort ---
    H = 256 if smoke else 2048
    hot_d = jnp.asarray(
        np.sort(rngs.choice(R_CACHE - 2, H, replace=False).astype(np.int32))
    )

    def timeit_chained_scalar(body, iters=1 if smoke else 3,
                              inner=2 if smoke else 10):
        @jax.jit
        def run(s):
            def f(acc, _):
                return acc + body(), None
            acc, _ = jax.lax.scan(f, s, None, length=inner)
            return acc
        s = run(jnp.int32(0)); _ = int(s)
        t0 = time.perf_counter()
        for _ in range(iters):
            s = run(s)
        _ = int(s)
        return (time.perf_counter() - t0) / (iters * inner)

    for method in ("scan", "sort"):
        dt = timeit_chained_scalar(
            lambda m=method: jnp.searchsorted(hot_d, slots_d, method=m).sum()
        )
        results.append({
            "kernel": f"searchsorted/{N_UPD}_keys_in_{H}/{method}",
            "ms": round(dt * 1e3, 2),
        })

    dev = jax.devices()[0]
    for r in results:
        r["device_kind"] = dev.device_kind
        print(json.dumps(r))


if __name__ == "__main__":
    main()
