"""Multi-host execution tests (parallel/multihost.py).

Host-logic units run in-process; the end-to-end tests launch REAL multi-
process JAX CPU clusters (2 procs x 2 devices, Gloo collectives) via
subprocesses and compare against a single-process run of the same global
mesh: same data, same seeds, bit-identical procedural masters => the
training trajectory must match (SURVEY.md §4: cluster-free multi-device
testing strategy, applied across processes)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cdlrm_tpu.parallel.multihost import (
    RowShard, ShardedMasterTables, WindowRowStore, exchange_window_rows,
)

_DIR = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_DIR, "mh_worker.py")


# --------------------------------------------------------------------- units
def test_row_shard_ranges_cover_and_partition():
    shard_counts = [1, 2, 3, 4, 7]
    for H in shard_counts:
        covered = []
        for h in range(H):
            lo, hi = RowShard(h, H).owned_range(100)
            covered.extend(range(lo, hi))
        assert covered == list(range(100))

    s = RowShard(1, 4)
    idx = np.array([0, 24, 25, 49, 50, 99])
    assert s.owner_of(idx, 100).tolist() == [0, 0, 1, 1, 2, 3]


def test_row_shard_bounds_split_sorted_ids():
    s = RowShard(0, 3)
    ids = np.array([1, 5, 33, 34, 35, 66, 67, 98], dtype=np.int64)
    b = s.bounds(ids, 99)  # per = 33: ranges [0,33) [33,66) [66,99)
    parts = [ids[b[h]: b[h + 1]] for h in range(3)]
    assert [p.tolist() for p in parts] == [[1, 5], [33, 34, 35], [66, 67, 98]]


def test_sharded_masters_union_equals_full(rng):
    ln_emb, dim = [97, 215], 8
    shards = [
        ShardedMasterTables(ln_emb, dim, RowShard(h, 3),
                            np.random.default_rng(5))
        for h in range(3)
    ]
    whole = ShardedMasterTables(ln_emb, dim, RowShard(0, 1),
                                np.random.default_rng(5))
    for t, n in enumerate(ln_emb):
        ids = np.unique(rng.integers(0, n, 64))
        parts = [s.gather(t, ids) for s in shards]
        assert np.array_equal(np.concatenate(parts), whole.gather(t, ids))


def test_sharded_masters_writeback_owned_only(rng):
    ln_emb, dim = [100], 4
    s = ShardedMasterTables(ln_emb, dim, RowShard(1, 2), np.random.default_rng(0))
    before = s.tables[0].copy()
    ids = np.array([10, 60], dtype=np.int64)  # 10 un-owned, 60 owned
    rows = np.ones((2, dim), np.float32)
    s.writeback(0, ids, rows)
    assert np.array_equal(s.tables[0][60 - 50], rows[1])
    changed = ~np.all(s.tables[0] == before, axis=1)
    assert changed.sum() == 1


def test_window_row_store_lookup_and_miss(rng):
    uniques = [np.array([3, 7, 11], dtype=np.int64)]
    rows = [np.arange(12, dtype=np.float32).reshape(3, 4)]
    store = WindowRowStore(uniques, rows)
    got = store.gather(0, np.array([11, 3, 3]))
    assert np.array_equal(got, rows[0][[2, 0, 0]])
    with pytest.raises(KeyError):
        store.gather(0, np.array([5]))


def test_exchange_window_rows_single_host_passthrough(rng):
    m = ShardedMasterTables([50], 4, RowShard(0, 1), np.random.default_rng(1))
    uniq = np.unique(rng.integers(0, 50, 20))
    rows = m.gather(0, uniq)
    out = exchange_window_rows(m, [uniq], [rows])
    assert np.array_equal(out[0], rows)


# ------------------------------------------------------------------ e2e
def _run_cluster(nproc, ndev_local, port, mode, tmp_path, timeout=900):
    outs = [str(tmp_path / f"out_{nproc}x{ndev_local}_{p}.json") for p in range(nproc)]
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    for p in range(nproc):
        procs.append(
            subprocess.Popen(
                [sys.executable, _WORKER, str(p), str(nproc), str(ndev_local),
                 str(port), outs[p], mode],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
        )
    results = []
    for p, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert proc.returncode == 0, (
            f"worker {p} failed:\n{stderr.decode()[-3000:]}"
        )
        with open(outs[p]) as f:
            results.append(json.load(f))
    return results


@pytest.mark.slow
def test_two_process_matches_single_process(tmp_path):
    single = _run_cluster(1, 4, 0, "one_window", tmp_path)[0]
    duo = _run_cluster(2, 2, 12411, "one_window", tmp_path)

    assert single["multihost"] is False
    assert all(r["multihost"] for r in duo)
    assert all(r["world"] == 4 for r in duo)
    # the two processes of one cluster must agree exactly (psum'd metrics)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert duo[0]["acc"] == pytest.approx(duo[1]["acc"])
    # cross-topology: same mesh, same data, bit-identical masters ==> same
    # trajectory (tolerance covers collective reduction-order effects)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-4), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)
    if single["auc"] is not None:
        assert single["auc"] == pytest.approx(duo[0]["auc"], abs=1e-6)
    # negotiated eval miss buckets (compiled global shapes) must be derived
    # identically on every host with zero communication
    assert duo[0]["eval_buckets"] and duo[0]["eval_buckets"] == duo[1]["eval_buckets"]


@pytest.mark.slow
def test_two_process_multi_window_with_writeback(tmp_path):
    duo = _run_cluster(2, 2, 12412, "multi_window", tmp_path)
    assert all(np.isfinite(r["losses"]).all() for r in duo)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    # windows beyond the first see hits (cache 32x4 ways >= table sizes'
    # hot set under the small id space)
    assert all(r["hit_rate"] > 0.2 for r in duo)
    # evictions were written back on both hosts (owned split)
    total_wb = sum(r["rows_written"] for r in duo)
    single = _run_cluster(1, 4, 0, "multi_window", tmp_path)[0]
    assert single["losses"] == pytest.approx(duo[0]["losses"], rel=2e-3)
    assert total_wb == single["rows_written"], (
        "sharded writebacks must partition the single-host writeback set"
    )


@pytest.mark.slow
def test_two_process_refill_prestage_matches_boundary_path(tmp_path):
    """Multi-host refill prestage (trainer._prefetch_next_window): hoisting
    the window-row allgather + plan join + insert H2D to mid-window must
    leave the trajectory identical to the boundary-time path — plan
    metadata is shadow-planned either way, and at this scale no writeback
    races the prefetcher's gathers (the single-host stager's pinned
    envelope, test_trainer_e2e.py::test_refill_prestage_matches_unstaged)."""
    pre = _run_cluster(2, 2, 12421, "multi_window", tmp_path)
    off = _run_cluster(2, 2, 12422, "noprestage", tmp_path)
    # the hoisted path actually engaged (one prefetch per non-first window)
    assert all(r["mh_prefetches"] > 0 for r in pre)
    assert all(r["mh_prefetches"] == 0 for r in off)
    assert np.allclose(pre[0]["losses"], off[0]["losses"], rtol=1e-6)
    assert pre[0]["hit_rate"] == pytest.approx(off[0]["hit_rate"])
    assert (
        sum(r["rows_written"] for r in pre)
        == sum(r["rows_written"] for r in off)
    )


@pytest.mark.slow
def test_two_process_midstream_resume(tmp_path):
    """Multi-host mid-window checkpoint/resume over a SHARED checkpoint dir
    (host-tagged shard files + the save-side visibility barrier): the
    resumed run's final cache and dense params must be bit-identical to the
    uninterrupted run on every host — asserted inside the worker
    (tests/mh_worker.py mode='resume'); the mh refill prestage is live
    throughout."""
    duo = _run_cluster(2, 2, 12423, "resume", tmp_path)
    assert all(r["multihost"] for r in duo)
    assert all(r["mh_prefetches"] > 0 for r in duo)
    # the |cache| signature is per-host (different replicas) — equality is
    # asserted in-worker against that host's own uninterrupted run
    assert all(np.isfinite(r["losses"]).all() for r in duo)


@pytest.mark.slow
def test_two_process_bin_host_slice(tmp_path):
    """config.data_host_slice e2e (bin loader): each host reads only its
    replicas' row range of every train batch; the trajectory must be
    bit-identical to the full-read run — asserted inside the worker
    (tests/mh_worker.py binslice_main). Pins that no train-path code
    consumes the zero-filled out-of-slice rows."""
    duo = _run_cluster(2, 2, 12424, "binslice", tmp_path)
    assert all(r["multihost"] for r in duo)
    assert duo[0]["acc"] == duo[1]["acc"]


@pytest.mark.slow
def test_two_process_pooled_multihot(tmp_path):
    """Padded multi-hot bags through the multi-host path (wire sentinel for
    masked positions, window-store misses, eval exchange) must match the
    single-process run."""
    single = _run_cluster(1, 4, 0, "pooled", tmp_path)[0]
    duo = _run_cluster(2, 2, 12415, "pooled", tmp_path)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)


@pytest.mark.parametrize("H", [4, 16])
def test_routed_row_exchange_simulated(rng, H):
    """GlobalRowExchange's request-routed protocol at simulated H=4 and
    H=16 (pod-scale shape for the vectorized packing — round-3 verdict
    item 8): the pure parts (_pack_requests / _owner_map / _contribution /
    _assemble) are driven directly, with the two process_allgathers replaced
    by stacking — every host must reconstruct exactly the rows a full
    (unsharded) master would return, and the routed payload must be O(cap)
    rows per host, not O(H*cap)."""
    from cdlrm_tpu.parallel.multihost import GlobalRowExchange

    ln_emb, dim, cap = [97, 215, 31], 8, 48
    masters = [
        ShardedMasterTables(ln_emb, dim, RowShard(h, H),
                            np.random.default_rng(5))
        for h in range(H)
    ]
    whole = ShardedMasterTables(ln_emb, dim, RowShard(0, 1),
                                np.random.default_rng(5))
    exs = [GlobalRowExchange(m, cap) for m in masters]

    # distinct random request lists per host (some empty tables, duplicates)
    reqs = []
    for h in range(H):
        r = []
        for t, n in enumerate(ln_emb):
            k = int(rng.integers(0, cap // len(ln_emb)))
            r.append((t, rng.integers(0, n, k)))
        reqs.append(r)

    # collective 1: allgather the packed requests
    all_req = np.stack([exs[h]._pack_requests(reqs[h]) for h in range(H)])
    owner_maps = [exs[h]._owner_map(all_req) for h in range(H)]
    for om in owner_maps[1:]:  # the layout plan is host-identical
        np.testing.assert_array_equal(om, owner_maps[0])
    owners = owner_maps[0]
    pad_to = max(1, int(max((owners == h).sum() for h in range(H))))
    # routed payload is O(cap), not O(H*cap): every request slot has exactly
    # one owner, so the summed payload equals the total live request count
    assert sum(int((owners == h).sum()) for h in range(H)) == int(
        (owners >= 0).sum()
    ) <= H * cap

    # collective 2: allgather the packed owned rows
    gathered = np.stack(
        [exs[h]._contribution(all_req, owners, pad_to) for h in range(H)]
    )
    for h in range(H):
        mine = exs[h]._assemble(owners, gathered)
        n = 0
        for t, ids in reqs[h]:
            expect = whole.tables[t][np.asarray(ids, np.int64)]
            np.testing.assert_array_equal(mine[n : n + ids.size], expect)
            n += ids.size


@pytest.mark.slow
def test_two_process_cached_md(tmp_path):
    """Cached MD across a real 2-process cluster: compact sharded masters,
    padded window exchange, projection training — the 2x2 trajectory must
    match the 1x4 single-process run (procedural values and projections are
    host-count-invariant)."""
    single = _run_cluster(1, 4, 0, "md", tmp_path)[0]
    duo = _run_cluster(2, 2, 12416, "md", tmp_path)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)


@pytest.mark.slow
def test_two_process_adagrad_matches_single(tmp_path):
    """optimizer='adagrad' across hosts: the cache-resident row-wise state
    (union-aggregate sync + refill insert-reset, train/step.py) must keep a
    2x2 cluster's trajectory identical to the single-process 1x4 run —
    same mesh, same data, bit-identical masters AND accumulators."""
    single = _run_cluster(1, 4, 0, "adagrad", tmp_path)[0]
    duo = _run_cluster(2, 2, 12418, "adagrad", tmp_path)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)


@pytest.mark.slow
def test_two_process_adagrad_master_state_matches_single(tmp_path):
    """adagrad_master_state across hosts (mh_worker 'adagrad_master'
    mode): the accumulator store is row-sharded with the masters —
    evicted state writes back host-locally to OWNED rows only, and resume
    values for un-owned rows ride the window exchange's extra f32 column
    (parallel/multihost.py exchange_window_rows accs lane). The 2x2
    cluster must agree with itself exactly and match the single-process
    1x4 run, whose unsharded store is gathered directly — any
    owned-range masking bug or mis-packed accs column diverges here."""
    single = _run_cluster(1, 4, 0, "adagrad_master", tmp_path)[0]
    duo = _run_cluster(2, 2, 12427, "adagrad_master", tmp_path)
    assert all(r["multihost"] for r in duo)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)
    # state actually round-tripped: the single store and the union of the
    # sharded stores are populated (evictions happened on this geometry)
    assert single["acc_store_nonzero"] > 0
    assert sum(r["acc_store_nonzero"] for r in duo) > 0


@pytest.mark.slow
def test_two_process_block_coalesce_matches_single(tmp_path):
    """block_coalesced_update across hosts (mh_worker 'blockco' mode: scan
    blocks + unpacked dedup wire, auto-resolved ON): the per-block union
    bucket is negotiated with one allgather-max on the main thread
    (trainer._build_block_union), so the 2x2 cluster must (a) agree with
    itself exactly, (b) match the single-process 1x4 trajectory, and (c)
    match the per-step multi_window-style path up to float reassociation —
    the worker asserts a coalesced block actually dispatched."""
    single = _run_cluster(1, 4, 0, "blockco", tmp_path)[0]
    duo = _run_cluster(2, 2, 12421, "blockco", tmp_path)
    assert all(r["multihost"] for r in duo)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=1e-6)
    # 4 hosts x 1 device: every host holds exactly one replica, so the
    # negotiated bucket is a pure cross-host max — the sharpest test of
    # the allgather-max (any local-only bucket choice diverges here)
    quad = _run_cluster(4, 1, 12423, "blockco", tmp_path)
    assert np.allclose(quad[0]["losses"], quad[3]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], quad[0]["losses"], rtol=2e-3), (
        single["losses"], quad[0]["losses"],
    )


def test_sharded_md_masters_pad_and_partition(rng):
    """Row-sharded MD masters (cached-MD multi-host leg): compact [*, d_t]
    owned storage, zero-padded pipeline-facing gathers that agree with the
    unsharded (H=1) procedural values, sliced writeback partitioned by
    ownership."""
    ln_emb, base = [97, 215, 31], 16
    dims = [8, 4, 16]
    whole = ShardedMasterTables(ln_emb, base, RowShard(0, 1),
                                np.random.default_rng(5), dims=dims)
    parts = [
        ShardedMasterTables(ln_emb, base, RowShard(h, 2),
                            np.random.default_rng(5), dims=dims)
        for h in range(2)
    ]
    for t, n in enumerate(ln_emb):
        assert whole.tables[t].shape[1] == dims[t]  # compact storage
        ids = np.unique(rng.integers(0, n, 40))
        want = whole.gather(t, ids)
        assert want.shape == (ids.size, base)
        np.testing.assert_array_equal(want[:, dims[t]:], 0.0)  # padded
        got = np.concatenate([p.gather(t, ids) for p in parts])
        np.testing.assert_array_equal(got, want)
        # gather_owned_of sums to the full padded rows
        any_order = rng.permutation(ids)
        s = parts[0].gather_owned_of(t, any_order) + parts[1].gather_owned_of(
            t, any_order
        )
        np.testing.assert_array_equal(s, whole.gather_owned_of(t, any_order))
        # writeback: padded rows in, compact owned slices stored, partitioned
        rows = rng.random((ids.size, base)).astype(np.float32)
        wrote = sum(p.writeback(t, ids, rows) for p in parts)
        assert wrote == ids.size
        whole.writeback(t, ids, rows)
        got2 = np.concatenate([p.gather(t, ids) for p in parts])
        np.testing.assert_array_equal(got2[:, : dims[t]], rows[:, : dims[t]])
        np.testing.assert_array_equal(got2, whole.gather(t, ids))


def test_count_misses_matches_probe(rng):
    """HostCacheController.count_misses (the window aux-bucket negotiation
    primitive) must agree exactly with probe's per-occurrence miss counts,
    with and without validity masks."""
    from cdlrm_tpu.cache.geometry import CacheGeometry
    from cdlrm_tpu.cache.host_cache import HostCacheController
    from cdlrm_tpu.cache.master import MasterTables

    ln_emb = np.array([50, 80])
    geo = CacheGeometry.build(ln_emb, dim=4, cache_size=16, ways=2,
                              aux_capacity=64)
    ctl = HostCacheController(geo, seed=3)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    # make some ids resident
    uniq = [np.unique(rng.integers(0, n, 20)) for n in ln_emb]
    rows = [master.gather(t, u) for t, u in enumerate(uniq)]
    ctl.plan_insert(uniq, rows)

    ls = np.stack([rng.integers(0, n, 32) for n in ln_emb])
    pr = ctl.probe(ls, master)
    misses = int(pr.num_lookups - pr.hit_counts.sum())
    assert ctl.count_misses(ls) == misses

    valid = rng.random((2, 32)) < 0.6
    prv = ctl.probe(ls, master, valid=valid)
    missesv = int(prv.num_lookups - prv.hit_counts.sum())
    assert ctl.count_misses(ls, valid=valid) == missesv


@pytest.mark.slow
def test_two_process_soak_all_features(tmp_path):
    """200-step 2-process soak with every round-2 feature on at once (scan
    blocks, insert-delta refill, negotiated miss bucket, direct-map probe,
    eviction-heavy geometry): trajectories must match the single-process run
    of the same global mesh, and the eviction writeback volume must agree —
    the combination stress that unit tests cannot cover."""
    single = _run_cluster(1, 4, 0, "soak", tmp_path)[0]
    duo = _run_cluster(2, 2, 12416, "soak", tmp_path)
    assert all(r["multihost"] for r in duo)
    assert np.allclose(duo[0]["losses"], duo[1]["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], duo[0]["losses"], rtol=2e-3), (
        single["losses"], duo[0]["losses"],
    )
    assert single["acc"] == pytest.approx(duo[0]["acc"], abs=5e-3)
    # both topologies must actually exercise eviction writeback
    assert single["rows_written"] > 0 and duo[0]["rows_written"] > 0


@pytest.mark.slow
def test_four_process_matches_two_and_one(tmp_path):
    """Host-count invariance across a third factorization of the same
    4-device global mesh: 4x1 must reproduce the 1x4 trajectory like 2x2
    does (procedural sharded masters + shared metadata mean host count is
    purely a placement choice — parallel/multihost.py)."""
    single = _run_cluster(1, 4, 0, "one_window", tmp_path)[0]
    quad = _run_cluster(4, 1, 12421, "one_window", tmp_path)
    assert all(r["multihost"] for r in quad)
    assert all(r["world"] == 4 for r in quad)
    for r in quad[1:]:
        assert np.allclose(quad[0]["losses"], r["losses"], rtol=1e-5)
    assert np.allclose(single["losses"], quad[0]["losses"], rtol=2e-4), (
        single["losses"], quad[0]["losses"],
    )
    assert single["acc"] == pytest.approx(quad[0]["acc"], abs=1e-6)
    assert quad[0]["eval_buckets"]
    for r in quad[1:]:
        assert r["eval_buckets"] == quad[0]["eval_buckets"]


@pytest.mark.slow
def test_four_process_soak_partitions_writebacks(tmp_path):
    """4-host soak (delta refill + scan blocks + hot tier + unpacked wires +
    auto-dedup, mh_worker 'soak' mode): trajectories agree across all four
    processes and the owned-range writebacks partition the single-process
    writeback set exactly."""
    quad = _run_cluster(4, 1, 12423, "soak", tmp_path)
    for r in quad[1:]:
        assert np.allclose(quad[0]["losses"], r["losses"], rtol=1e-5)
    assert all(np.isfinite(r["losses"]).all() for r in quad)
    single = _run_cluster(1, 4, 0, "soak", tmp_path)[0]
    assert single["losses"] == pytest.approx(quad[0]["losses"], rel=2e-3)
    assert sum(r["rows_written"] for r in quad) == single["rows_written"]
