"""Jitted step correctness: sparse-update locality, DP-vs-single-device
equivalence, refill broadcast, and touched-row aggregation semantics."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu.models.dlrm import derive_top_mlp_input_dim, init_dlrm
from cdlrm_tpu.parallel.mesh import make_dp_mesh
from cdlrm_tpu.train import step as step_lib

T, D, DEN = 3, 8, 13


def build(ndev, b_glob, rng_seed=0, **cfg_kw):
    rng = np.random.default_rng(rng_seed)
    ln_emb = [64, 32, 128]
    geo = CacheGeometry.build(ln_emb, D, 8, 2, aux_capacity=b_glob // ndev)
    mesh = make_dp_mesh(ndev)
    ln_bot = [DEN, 16, D]
    ln_top = [derive_top_mlp_input_dim(T, D, "dot", False), 8, 1]
    params = init_dlrm(rng, ln_bot, ln_top)
    params_r = step_lib.replicate_for_mesh(params, mesh)
    lead = NamedSharding(mesh, P("dp"))
    cache_host = rng.normal(size=(geo.total_rows, D)).astype(np.float32)
    # flat per-replica layout: [ndev*R, D] (train/step.py module doc)
    cache = jax.device_put(jnp.asarray(np.tile(cache_host, (ndev, 1))), lead)
    touched = jax.device_put(jnp.zeros(ndev * geo.total_rows, bool), lead)
    scfg = step_lib.StepConfig(loss_function="bce", **cfg_kw)
    return mesh, geo, params_r, cache, touched, scfg, cache_host


def make_batch(geo, b, rng_seed=1, ndev=1):
    rng = np.random.default_rng(rng_seed)
    x = rng.random((b, DEN)).astype(np.float32)
    tgt = np.round(rng.random((b, 1))).astype(np.float32)
    # slots point at real (non-aux) rows only, so aux content is irrelevant
    slots = np.stack(
        [
            rng.integers(0, geo.ways * geo.sets[t], b).astype(np.int32)
            + geo.table_offsets[t].astype(np.int32)
            for t in range(T)
        ]
    )
    aux_slots = np.full(ndev * 8, geo.trash_row, np.int32)
    aux_rows = np.zeros((ndev * 8, D), np.float32)
    return x, slots, (aux_slots, aux_rows), tgt


def blocks(arr, ndev, rows):
    """[ndev*R, ...] flat state -> [ndev, R, ...] numpy view."""
    a = np.asarray(arr)
    return a.reshape((ndev, rows) + a.shape[1:])


def put(mesh, x, slots, aux, tgt):
    aux_slots, aux_rows = aux
    mask = np.zeros(slots.shape, bool)
    return (
        jax.device_put(x, NamedSharding(mesh, P("dp"))),
        jax.device_put(slots, NamedSharding(mesh, P(None, "dp"))),
        jax.device_put(mask, NamedSharding(mesh, P(None, "dp"))),
        jax.device_put(aux_slots, NamedSharding(mesh, P("dp"))),
        jax.device_put(aux_rows, NamedSharding(mesh, P("dp"))),
        jax.device_put(tgt, NamedSharding(mesh, P("dp"))),
    )


def test_sparse_update_locality():
    """Only gathered slots (and the aux regions) change in the cache."""
    mesh, geo, params, cache, touched, scfg, cache_host = build(1, 8)
    step = step_lib.make_cached_train_step(mesh, geo, scfg)
    x, slots, aux, tgt = make_batch(geo, 8)
    xd, sd, md, asd, ard, td = put(mesh, x, slots, aux, tgt)
    params, cache, touched, loss, correct = step(
        params, cache, touched, xd, sd, md, asd, ard, td,
        jnp.float32(0.1), jnp.float32(0.3)
    )
    new_cache = blocks(cache, 1, geo.total_rows)[0]
    touched_np = blocks(touched, 1, geo.total_rows)[0]
    expected_touched = np.zeros(geo.total_rows, bool)
    expected_touched[slots.reshape(-1)] = True
    np.testing.assert_array_equal(touched_np, expected_touched)
    aux_rows = np.zeros(geo.total_rows, bool)
    for t in range(T):
        aux_rows[geo.aux_base(t) : geo.aux_base(t) + geo.aux_capacity] = True
    aux_rows[geo.trash_row] = True  # padding scatters land here
    unchanged = ~(expected_touched | aux_rows)
    np.testing.assert_allclose(new_cache[unchanged], cache_host[unchanged])
    # touched rows actually moved
    assert np.abs(new_cache[expected_touched] - cache_host[expected_touched]).max() > 0


def test_sparse_update_matches_manual_sgd():
    """Cache delta equals -lr * scatter-add of row gradients computed by a
    plain autodiff-through-the-cache oracle."""
    mesh, geo, params, cache, touched, scfg, cache_host = build(1, 4)
    step = step_lib.make_cached_train_step(mesh, geo, scfg)
    x, slots, aux, tgt = make_batch(geo, 4)
    # introduce duplicates: coalescing must accumulate
    slots[0, 1] = slots[0, 0]
    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward

    p0 = step_lib.unreplicate(params)

    def oracle_loss(cache_arr):
        rows = cache_arr[slots.reshape(-1)].reshape(T, 4, D)
        p = dlrm_forward(p0, jnp.asarray(x), rows)
        return compute_loss(p, jnp.asarray(tgt), "bce")

    g_cache = np.asarray(jax.grad(oracle_loss)(jnp.asarray(cache_host)))
    xd, sd, md, asd, ard, td = put(mesh, x, slots, aux, tgt)
    _, cache, _, _, _ = step(
        params, cache, touched, xd, sd, md, asd, ard, td,
        jnp.float32(0.0), jnp.float32(0.3)
    )
    new_cache = blocks(cache, 1, geo.total_rows)[0]
    delta = new_cache - cache_host
    mask = np.zeros(geo.total_rows, bool)
    mask[slots.reshape(-1)] = True
    np.testing.assert_allclose(delta[mask], -0.3 * g_cache[mask], rtol=1e-4, atol=1e-6)


def test_dp_matches_single_device():
    """8-way DP on the global batch must produce the same dense params,
    metrics, and per-replica cache updates as 1-device training on the same
    batch would for its shard."""
    b = 16
    mesh8, geo, params8, cache8, touched8, scfg, cache_host = build(8, b)
    step8 = step_lib.make_cached_train_step(mesh8, geo, scfg)
    x, slots, aux8, tgt = make_batch(geo, b, ndev=8)
    xd, sd, md, asd, ard, td = put(mesh8, x, slots, aux8, tgt)
    params8, cache8, touched8, loss8, corr8 = step8(
        params8, cache8, touched8, xd, sd, md, asd, ard, td,
        jnp.float32(0.1), jnp.float32(0.3)
    )

    # oracle: average of per-shard dense grads == grad of mean-of-shard-losses
    mesh1, geo1, params1, cache1, touched1, _, _ = build(1, b // 8)
    step1 = step_lib.make_cached_train_step(mesh1, geo1, scfg)
    # run each shard independently on the single-device step with lr=0 to get
    # per-shard losses; then check the DP loss_sum is their sum
    total = 0.0
    for r in range(8):
        xs = x[r * 2 : (r + 1) * 2]
        ss = slots[:, r * 2 : (r + 1) * 2]
        ts = tgt[r * 2 : (r + 1) * 2]
        aux1 = (np.full(8, geo1.trash_row, np.int32),
                np.zeros((8, D), np.float32))
        xd1, sd1, md1, asd1, ard1, td1 = put(mesh1, xs, ss, aux1, ts)
        # cache1/touched1 are donated; thread the returned buffers through
        _, cache1, touched1, l1, c1 = step1(
            params1, cache1, touched1, xd1, sd1, md1, asd1, ard1, td1,
            jnp.float32(0.0), jnp.float32(0.0),
        )
        total += float(l1)
    assert abs(float(loss8) - total) < 1e-3

    # replica caches: each shard updated only its own slots
    for r in range(8):
        shard_slots = slots[:, r * 2 : (r + 1) * 2].reshape(-1)
        other = np.ones(geo.total_rows, bool)
        other[shard_slots] = False
        other[geo.trash_row] = False
        for t in range(T):
            other[geo.aux_base(t) : geo.aux_base(t) + geo.aux_capacity] = False
        np.testing.assert_allclose(
            blocks(cache8, 8, geo.total_rows)[r][other], cache_host[other],
            atol=1e-6,
        )


def test_refill_broadcast_and_evict_order():
    mesh, geo, params, cache, touched, scfg, cache_host = build(4, 8)
    refill = step_lib.make_refill_step(mesh, scfg)
    # make replicas diverge first
    diverged = np.stack([cache_host + r for r in range(4)])
    lead = NamedSharding(mesh, P("dp"))
    cache = jax.device_put(jnp.asarray(diverged.reshape(-1, D)), lead)
    ins_slots = np.array([5, 6], np.int32)
    ins_rows = np.full((2, D), 42.0, np.float32)
    ev_slots = np.array([5, 7], np.int32)
    cache, evicted = refill(
        cache, jnp.asarray(ins_slots), jnp.asarray(ins_rows), jnp.asarray(ev_slots)
    )
    # evicted rows are PRE-insert values, broadcast from replica 0
    np.testing.assert_allclose(blocks(evicted, 4, 2)[0], diverged[0][[5, 7]])
    out = blocks(cache, 4, geo.total_rows)
    # all replicas equal replica 0 post-insert
    for r in range(1, 4):
        np.testing.assert_allclose(out[r], out[0])
    np.testing.assert_allclose(out[0][5], 42.0)
    np.testing.assert_allclose(out[0][7], diverged[0][7])


def test_refill_no_broadcast_keeps_divergence():
    mesh, geo, params, cache, touched, scfg, cache_host = build(
        4, 8, refill_broadcast=False
    )
    refill = step_lib.make_refill_step(mesh, scfg)
    diverged = np.stack([cache_host + r for r in range(4)])
    cache = jax.device_put(jnp.asarray(diverged.reshape(-1, D)),
                           NamedSharding(mesh, P("dp")))
    cache, _ = refill(
        cache,
        jnp.asarray(np.array([geo.trash_row], np.int32)),
        jnp.asarray(np.zeros((1, D), np.float32)),
        jnp.asarray(np.array([0], np.int32)),
    )
    out = blocks(cache, 4, geo.total_rows)
    np.testing.assert_allclose(out[3][:5], diverged[3][:5])


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("bucket", [None, 16])
def test_aggregate_ops(op, bucket):
    mesh, geo, params, cache, touched, scfg, cache_host = build(4, 8, table_agg_op=op)
    agg = step_lib.make_aggregate_step(
        mesh, scfg, union_bucket=bucket, trash_row=geo.trash_row
    )
    diverged = np.stack([cache_host * (r + 1) for r in range(4)])
    lead = NamedSharding(mesh, P("dp"))
    cache = jax.device_put(jnp.asarray(diverged.reshape(-1, D)), lead)
    tmask = np.zeros((4, geo.total_rows), bool)
    tmask[0, 3] = True  # row 3 touched by replica 0 only
    tmask[2, 9] = True
    tmask[3, 9] = True  # row 9 touched by replicas 2 and 3
    touched = jax.device_put(jnp.asarray(tmask.reshape(-1)), lead)
    cache, touched = agg(cache, touched)
    out = blocks(cache, 4, geo.total_rows)
    stack = diverged[:, 3]
    if op == "sum":
        exp3 = stack.sum(0)
    elif op == "mean":
        exp3 = stack.mean(0)
    else:
        exp3 = stack.max(0)
    for r in range(4):
        np.testing.assert_allclose(out[r][3], exp3, rtol=1e-5)
        # untouched rows keep local values
        np.testing.assert_allclose(out[r][4], diverged[r][4], rtol=1e-6)
    assert not np.asarray(touched).any()


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_aggregate_sparse_equals_dense(op):
    """The padded union-slot exchange must be bit-equivalent to the dense
    masked allreduce it replaces on random touched masks,
    including rows touched by no/one/all replicas and an exactly-full
    bucket."""
    ndev = 4
    mesh, geo, params, cache, touched, scfg, cache_host = build(
        ndev, 8, table_agg_op=op
    )
    rng = np.random.default_rng(7)
    diverged = rng.normal(size=(ndev, geo.total_rows, D)).astype(np.float32)
    tmask = rng.random((ndev, geo.total_rows)) < 0.15
    tmask[:, geo.trash_row] = False  # the train step never marks trash
    union_count = int((tmask.any(axis=0)).sum())
    lead = NamedSharding(mesh, P("dp"))

    def run(step):
        c = jax.device_put(jnp.asarray(diverged.reshape(-1, D)), lead)
        t = jax.device_put(jnp.asarray(tmask.reshape(-1)), lead)
        c, t = step(c, t)
        return np.asarray(c), np.asarray(t)

    dense = step_lib.make_aggregate_step(mesh, scfg)
    sparse = step_lib.make_aggregate_step(
        mesh, scfg, union_bucket=union_count, trash_row=geo.trash_row
    )
    c_dense, t_dense = run(dense)
    c_sparse, t_sparse = run(sparse)
    keep = np.ones(geo.total_rows, bool)
    keep[geo.trash_row] = False  # trash value is unspecified by contract
    keep_flat = np.tile(keep, ndev)
    np.testing.assert_allclose(
        c_sparse[keep_flat], c_dense[keep_flat], rtol=1e-5, atol=1e-6
    )
    assert not t_sparse.any() and not t_dense.any()


def test_fulltable_step_runs_and_learns():
    from cdlrm_tpu.models.embedding import init_embedding_tables

    rng = np.random.default_rng(0)
    mesh = make_dp_mesh(4)
    ln_emb = [50, 30, 80]
    ln_bot = [DEN, 16, D]
    ln_top = [derive_top_mlp_input_dim(T, D, "dot", False), 8, 1]
    params = {
        **init_dlrm(rng, ln_bot, ln_top),
        "emb": init_embedding_tables(rng, ln_emb, D),
    }
    params = step_lib.replicate_for_mesh(params, mesh)
    scfg = step_lib.StepConfig(loss_function="bce")
    step = step_lib.make_fulltable_train_step(mesh, scfg)
    b = 32
    x = rng.random((b, DEN)).astype(np.float32)
    ls_i = np.stack([rng.integers(0, n, b) for n in ln_emb])
    # separable target so loss must drop
    tgt = (x[:, :1] > 0.5).astype(np.float32)
    xd = jax.device_put(x, NamedSharding(mesh, P("dp")))
    sd = jax.device_put(ls_i, NamedSharding(mesh, P(None, "dp")))
    md = jax.device_put(np.zeros_like(ls_i), NamedSharding(mesh, P(None, "dp")))
    td = jax.device_put(tgt, NamedSharding(mesh, P("dp")))
    losses = []
    for _ in range(30):
        params, loss_sum, _ = step(
            params, xd, sd, md, td, jnp.float32(0.2), jnp.float32(0.2)
        )
        losses.append(float(loss_sum) / b)
    assert losses[-1] < losses[0] * 0.9


def test_decode_dedup_raw_matches_packed(rng):
    """The packed (_decode_dedup) and unpacked (_decode_dedup_raw) wire
    decoders must produce identical (uniq_slots, ginv) for equivalent host
    emissions — the two ends of the host probe's packed/raw duality
    (host_cache.probe_dedup vs probe_dedup_raw)."""
    geo = CacheGeometry.build((50, 30, 80), 4, 8, 2, 16)
    t_count, n = 3, 12
    inv_bits = 9
    ub = 16
    uniq_bits = 9
    # fabricate host outputs: per-table local ranks with sentinels + local
    # unique slot lists
    ranks = np.full((t_count, n), -1, np.int64)
    counts = np.zeros(t_count, np.int64)
    local_uniqs = []
    for t in range(t_count):
        valid = rng.random(n) < 0.8
        slots_local = rng.integers(0, 4, n)  # <=4 uniques/table, fits ub
        seen = {}
        for i in np.flatnonzero(valid):
            s = int(slots_local[i])
            if s not in seen:
                seen[s] = len(seen)
            ranks[t, i] = seen[s]
        counts[t] = len(seen)
        local_uniqs.append(
            np.array(sorted(seen, key=seen.get), np.int64)
        )
    # packed wires
    inv_packed = step_lib.pack_slots(
        ranks, np.zeros(t_count, np.int64), -1, inv_bits
    )
    vals = np.full(ub, -1, np.int64)
    pos = 1
    for u in local_uniqs:
        vals[pos: pos + u.size] = u
        pos += u.size
    uniq_packed = step_lib.pack_slots(
        vals[None], np.zeros(1, np.int64), -1, uniq_bits
    )[0]
    us_p, gi_p = jax.jit(
        lambda a, b, c: step_lib._decode_dedup(
            a, b, c, geo, inv_bits, uniq_bits, n
        )
    )(inv_packed, uniq_packed, counts.astype(np.int32))
    # raw wires: int32 ranks + GLOBAL unique rows
    raw_uniq = np.full(ub, geo.trash_row, np.int32)
    pos = 1
    for t, u in enumerate(local_uniqs):
        raw_uniq[pos: pos + u.size] = geo.table_offsets[t] + u
        pos += u.size
    us_r, gi_r = jax.jit(step_lib._decode_dedup_raw)(
        ranks.astype(np.int32), raw_uniq, counts.astype(np.int32)
    )
    np.testing.assert_array_equal(np.asarray(us_p), np.asarray(us_r))
    np.testing.assert_array_equal(np.asarray(gi_p), np.asarray(gi_r))


def test_dense_adagrad_matches_torch():
    """_dense_adagrad pins torch.optim.Adagrad semantics exactly
    (std = sqrt(state_sum) + eps, eps OUTSIDE the sqrt) so the dense half
    of optimizer='adagrad' is lockstep-verifiable against torch."""
    import pytest as _pytest
    torch = _pytest.importorskip("torch")
    import jax.numpy as jnp
    from cdlrm_tpu.train.step import _dense_adagrad

    rng = np.random.default_rng(7)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    lr, eps = 0.1, 1e-10

    tw = torch.nn.Parameter(torch.tensor(w0.copy()))
    opt = torch.optim.Adagrad([tw], lr=lr, eps=eps)
    jw = {"w": jnp.asarray(w0)}
    jacc = {"w": jnp.zeros_like(jw["w"])}
    for step in range(6):
        g = rng.normal(size=w0.shape).astype(np.float32)
        opt.zero_grad()
        tw.grad = torch.tensor(g)
        opt.step()
        jw, jacc = _dense_adagrad(jw, {"w": jnp.asarray(g)}, lr, jacc, eps)
        np.testing.assert_allclose(
            np.asarray(jw["w"]), tw.detach().numpy(), rtol=1e-5, atol=1e-7)
