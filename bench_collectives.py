"""Collective-traffic accounting from compiled HLO.

Compiles the jitted steps over an 8-virtual-device CPU mesh at a scaled
Terabyte-like geometry and reports the per-invocation collective bytes of
each variant pair the config exposes:

  - refill_broadcast strict (whole-cache psum) vs delta (evicted rows only)
  - table aggregation sparse union-bucket vs dense masked allreduce
  - the train step's dense-grad pmean + metric psum

Byte counts come from the compiled HLO text (result shapes of all-reduce /
all-gather / reduce-scatter / collective-permute / all-to-all ops), i.e.
what XLA actually materializes for the collective — shard-local logical
bytes; link traffic is a ring-algorithm multiple of this, identical across
compared variants. Prints one JSON line per measurement.
"""

import json
import os
import re
import sys


def setup_cpu_mesh():
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"= ((?:\([^)]*\))|(?:\S+)) (all-reduce|all-gather|reduce-scatter|"
    r"collective-permute|all-to-all)"
)
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(compiled) -> dict:
    """Sum HLO collective result bytes by op kind for a compiled function."""
    out = {}
    for mod_text in [compiled.as_text()]:
        for shape, kind in _COLL_RE.findall(mod_text):
            out[kind] = out.get(kind, 0) + _shape_bytes(shape)
    return out


def main():
    jax = setup_cpu_mesh()
    import jax.numpy as jnp
    import numpy as np

    from cdlrm_tpu.cache.geometry import CacheGeometry
    from cdlrm_tpu.models.dlrm import derive_top_mlp_input_dim, init_dlrm
    from cdlrm_tpu.parallel.mesh import make_dp_mesh
    from cdlrm_tpu.train import step as step_lib

    ndev = 8
    mesh = make_dp_mesh(ndev)
    # scaled geometry: 26 tables x 4096-set x 4-way, dim 32, global batch 512
    # (1/4 linear scale of the bench config in rows/dim; byte RATIOS between
    # variants are scale-independent)
    t_count, d, b = 26, 32, 512
    ln_emb = [50_000] * t_count
    geo = CacheGeometry.build(ln_emb, d, 4096, 4, aux_capacity=b // ndev)
    R = geo.total_rows
    ln_bot = [13, 64, d]
    ln_top = [derive_top_mlp_input_dim(t_count, d, "dot", False), 64, 1]
    rng = np.random.default_rng(0)
    params = step_lib.replicate_for_mesh(init_dlrm(rng, ln_bot, ln_top), mesh)

    from jax.sharding import NamedSharding, PartitionSpec as P

    lead = NamedSharding(mesh, P("dp"))
    cache = jax.device_put(jnp.zeros((ndev * R, d), jnp.float32), lead)
    touched = jax.device_put(jnp.zeros(ndev * R, bool), lead)
    scfg = step_lib.StepConfig(loss_function="bce")
    results = []

    # ---- refill: strict vs delta, at a realistic insert/evict count ----
    n_ins, n_ev = 4096, 2048
    ins_slots = jnp.asarray(
        rng.integers(0, R - 1, n_ins).astype(np.int32))
    ins_rows = jnp.zeros((n_ins, d), jnp.float32)
    ev_slots = jnp.asarray(rng.integers(0, R - 1, n_ev).astype(np.int32))
    for mode in ("strict", "delta"):
        fn = step_lib.make_refill_step(
            mesh, scfg._replace(refill_broadcast=mode))
        compiled = fn.lower(cache, ins_slots, ins_rows, ev_slots).compile()
        byt = collective_bytes(compiled)
        results.append({
            "step": f"refill_{mode}", "collective_bytes": byt,
            "total": sum(byt.values()),
            "inserts": n_ins, "evicts": n_ev, "cache_rows": int(R),
        })

    # ---- aggregation: sparse union bucket vs dense masked allreduce ----
    bucket = 1 << 15
    for name, ub in (("sparse", bucket), ("dense", None)):
        fn = step_lib.make_aggregate_step(
            mesh, scfg, union_bucket=ub, trash_row=geo.trash_row)
        compiled = fn.lower(cache, touched).compile()
        byt = collective_bytes(compiled)
        results.append({
            "step": f"aggregate_{name}", "collective_bytes": byt,
            "total": sum(byt.values()),
            "union_bucket": ub, "cache_rows": int(R),
        })

    # ---- train step: dense-grad pmean + metric psum ----
    train = step_lib.make_cached_train_step(mesh, geo, scfg)
    x = jax.device_put(rng.random((b, 13)).astype(np.float32),
                       NamedSharding(mesh, P("dp")))
    slots = jax.device_put(
        np.stack([
            rng.integers(0, geo.ways * geo.sets[t], b).astype(np.int32)
            + geo.table_offsets[t].astype(np.int32)
            for t in range(t_count)
        ]),
        NamedSharding(mesh, P(None, "dp")))
    k = b // ndev
    aux_slots = jax.device_put(
        np.full(ndev * k, geo.trash_row, np.int32), lead)
    aux_rows = jax.device_put(np.zeros((ndev * k, d), np.float32), lead)
    ls_mask = jax.device_put(np.zeros((t_count, b), bool),
                             NamedSharding(mesh, P(None, "dp")))
    tgt = jax.device_put(np.round(rng.random((b, 1))).astype(np.float32),
                         NamedSharding(mesh, P("dp")))
    compiled = train.lower(
        params, cache, touched, x, slots, ls_mask, aux_slots, aux_rows, tgt,
        jnp.float32(0.1), jnp.float32(0.3)).compile()
    byt = collective_bytes(compiled)
    results.append({
        "step": "train", "collective_bytes": byt,
        "total": sum(byt.values()), "global_batch": b,
    })

    # ---- adagrad: accum ride-along cost in aggregation (round 4) ----
    # the [R]-f32 accum joins the union sync; at the sparse bucket its
    # collective cost is bucket*4 bytes (vs bucket*d*4 for the rows) —
    # ~1/d relative overhead
    accum = jax.device_put(jnp.zeros(ndev * R, jnp.float32), lead)
    scfg_ag = scfg._replace(optimizer="adagrad")
    fn = step_lib.make_aggregate_step(
        mesh, scfg_ag, union_bucket=bucket, trash_row=geo.trash_row)
    compiled = fn.lower(cache, touched, accum).compile()
    byt = collective_bytes(compiled)
    results.append({
        "step": "aggregate_sparse_adagrad", "collective_bytes": byt,
        "total": sum(byt.values()), "union_bucket": bucket,
    })

    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
