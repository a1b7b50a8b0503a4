"""Cache semantics: geometry, probe hit/miss resolution, and the insert/evict
policy — property-tested against a transparent oracle of the reference
algorithm (CacheEmbeddings, /root/reference/main_no_ddp.py:148-209)."""

import numpy as np
import pytest

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu.cache.host_cache import HostCacheController
from cdlrm_tpu.cache.master import MasterTables


def make_setup(ln_emb=(100, 7), dim=4, cache_size=10, ways=2, aux=8, seed=0):
    geo = CacheGeometry.build(ln_emb, dim, cache_size, ways, aux)
    master = MasterTables(ln_emb, dim, np.random.default_rng(seed))
    ctrl = HostCacheController(geo, seed=seed)
    return geo, master, ctrl


def test_geometry_layout():
    geo, _, _ = make_setup()
    # next_prime(10) = 11 sets for the big table; small table (7 rows) is
    # fully resident with 7 sets (reference model_no_ddp.py:136)
    assert list(geo.sets) == [11, 7]
    assert geo.table_offsets[0] == 0
    assert geo.table_offsets[1] == 2 * 11 + 8
    assert geo.total_rows == (2 * 11 + 8) + (2 * 7 + 8) + 1
    assert geo.aux_base(0) == 22
    assert geo.trash_row == geo.total_rows - 1


def test_probe_all_miss_then_hit():
    geo, master, ctrl = make_setup()
    ls_i = np.array([[1, 12, 1], [3, 3, 6]])  # table0: 1 and 12 collide (set 1)
    pr = ctrl.probe(ls_i, master)
    # empty cache: everything misses, aux slots in batch order
    assert pr.hit_counts.tolist() == [0, 0]
    assert pr.slots[0].tolist() == [22, 23, 24]
    assert pr.slots[1].tolist() == [geo.aux_base(1), geo.aux_base(1) + 1, geo.aux_base(1) + 2]
    # packed aux: slots enumerate each table's aux region in miss order,
    # rows carry the master values of the missing indices
    np.testing.assert_array_equal(
        pr.aux_slots,
        [22, 23, 24, geo.aux_base(1), geo.aux_base(1) + 1, geo.aux_base(1) + 2],
    )
    np.testing.assert_allclose(pr.aux_rows[0], master.tables[0][1])
    np.testing.assert_allclose(pr.aux_rows[1], master.tables[0][12])
    np.testing.assert_allclose(pr.aux_rows[2], master.tables[0][1])

    # insert idx 1 and 12 (same set, different ways) and re-probe
    plan = ctrl.plan_insert([np.array([1, 12]), np.array([], np.int64)],
                            [master.tables[0][[1, 12]], np.zeros((0, 4), np.float32)])
    assert plan.insert_slots.shape[0] == 2
    pr2 = ctrl.probe(ls_i, master)
    assert pr2.hit_counts.tolist() == [3, 0]
    # both hit slots lie inside table 0's way region
    assert (pr2.slots[0] < geo.aux_base(0)).all()
    # and point at distinct ways of set 1
    assert sorted(pr2.slots[0][[0, 1]] % 11) == [1, 1]
    assert pr2.slots[0][0] != pr2.slots[0][1]
    assert pr2.slots[0][2] == pr2.slots[0][0]  # same idx -> same slot


def test_insert_respects_way_capacity():
    # 3 indices map to the same set of a 2-way cache: only 2 can land
    geo, master, ctrl = make_setup()
    u = np.array([1, 12, 23])  # all ≡ 1 mod 11
    plan = ctrl.plan_insert([u, np.array([], np.int64)],
                            [master.tables[0][u], np.zeros((0, 4), np.float32)])
    assert plan.insert_slots.shape[0] == 2
    resident = set(ctrl.occupancy[0][1].tolist())
    assert -1 not in resident
    assert resident < set(u.tolist()) | {-1} or len(resident) == 2


def test_insert_protects_window_hits_and_evicts_old():
    geo, master, ctrl = make_setup()
    # fill set 1 of table 0 with 1 and 12
    ctrl.plan_insert([np.array([1, 12]), np.array([], np.int64)],
                     [master.tables[0][[1, 12]], np.zeros((0, 4), np.float32)])
    # new window: 1 (hit, protected) + 23 (miss, must evict 12)
    plan = ctrl.plan_insert([np.array([1, 23]), np.array([], np.int64)],
                            [master.tables[0][[1, 23]], np.zeros((0, 4), np.float32)])
    assert plan.insert_slots.shape[0] == 1
    assert plan.evict_idxs.tolist() == [12]
    assert plan.evict_tables.tolist() == [0]
    # evict slot is where 12 lived; occupancy now holds 1 and 23
    assert set(ctrl.occupancy[0][1].tolist()) == {1, 23}


def test_insert_rows_alignment():
    """insert_rows[i] must be the master row of the index now occupying
    insert_slots[i]."""
    geo, master, ctrl = make_setup(ln_emb=(1000,), cache_size=50, ways=4)
    u = np.unique(np.random.default_rng(3).integers(0, 1000, 300))
    plan = ctrl.plan_insert([u], [master.tables[0][u]])
    sets0 = geo.sets[0]
    for slot, row in zip(plan.insert_slots, plan.insert_rows):
        way, set_idx = divmod(int(slot) - int(geo.table_offsets[0]), int(sets0))
        idx = ctrl.occupancy[0][set_idx, way]
        np.testing.assert_allclose(row, master.tables[0][idx])


def test_insert_slots_unique():
    geo, master, ctrl = make_setup(ln_emb=(10000,), cache_size=10, ways=2)
    u = np.unique(np.random.default_rng(4).integers(0, 10000, 500))
    plan = ctrl.plan_insert([u], [master.tables[0][u]])
    assert len(np.unique(plan.insert_slots)) == len(plan.insert_slots)
    assert len(np.unique(plan.evict_slots)) == len(plan.evict_slots)


def test_occupancy_consistency_random_trace():
    """Long random workload: occupancy always consistent with probe result
    and never exceeds way capacity."""
    rng = np.random.default_rng(7)
    geo, master, ctrl = make_setup(ln_emb=(5000, 64), cache_size=30, ways=4, aux=64)
    for _ in range(20):
        window = [np.unique(rng.integers(0, n, 200)) for n in (5000, 64)]
        rows = master.gather_all(window)
        ctrl.plan_insert(window, rows)
        for t, n in enumerate((5000, 64)):
            occ = ctrl.occupancy[t]
            live = occ[occ >= 0]
            assert live.size == np.unique(live).size  # no duplicate residents
            # every resident maps to its own set
            sets_t = geo.sets[t]
            set_of = np.nonzero(occ >= 0)
            assert ((occ[set_of] % sets_t) == set_of[0]).all()
        batch = np.stack([rng.integers(0, 5000, 32), rng.integers(0, 64, 32)])
        pr = ctrl.probe(batch, master)
        # every resident index must probe as a hit
        for t in range(2):
            resident = set(ctrl.occupancy[t][ctrl.occupancy[t] >= 0].tolist())
            for b, idx in enumerate(batch[t]):
                is_hit = pr.slots[t][b] < geo.aux_base(t)
                assert is_hit == (int(idx) in resident)


def test_master_writeback_average():
    master = MasterTables([10], 4, np.random.default_rng(0))
    before = master.tables[0][[2, 5]].copy()
    rows = np.ones((2, 4), np.float32)
    master.writeback(0, np.array([2, 5]), rows, average=False)
    np.testing.assert_allclose(master.tables[0][[2, 5]], rows)
    master.writeback(0, np.array([2]), np.zeros((1, 4), np.float32), average=True)
    np.testing.assert_allclose(master.tables[0][2], 0.5 * np.ones(4))


@pytest.mark.parametrize("use_valid", [False, True])
def test_slot_map_probe_bit_identical(use_valid):
    """The direct-map probe (slot_map=True; the O(1) host probe) must be
    bit-identical to the occupancy-walk probe across a random stream of
    probes and refills with evictions — slots, aux assignment, hit counts,
    and the packed wire. Also pins rebuild_slot_map (checkpoint load)."""
    from cdlrm_tpu.train.step import wire_width

    ln_emb = (100, 7, 63)
    rng = np.random.default_rng(42)
    geo = CacheGeometry.build(ln_emb, 4, 10, 2, 32)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    a = HostCacheController(geo, seed=5)
    b = HostCacheController(geo, seed=5, ln_emb=np.asarray(ln_emb),
                            slot_map=True)
    bits = wire_width(int((geo.ways * geo.sets + geo.aux_capacity).max()) - 1)
    for step in range(12):
        ls = np.stack([rng.integers(0, n, 24) for n in ln_emb])
        valid = (rng.random((3, 24)) < 0.8) if use_valid else None
        pa = a.probe(ls, master, valid=valid)
        pb = b.probe(ls, master, valid=valid)
        np.testing.assert_array_equal(pa.slots, pb.slots)
        np.testing.assert_array_equal(pa.aux_slots, pb.aux_slots)
        np.testing.assert_allclose(pa.aux_rows, pb.aux_rows)
        assert pa.hit_counts.tolist() == pb.hit_counts.tolist()
        assert pa.num_lookups == pb.num_lookups
        wa = a.probe_wire(ls, master, bits, valid=valid)
        wb = b.probe_wire(ls, master, bits, valid=valid)
        np.testing.assert_array_equal(wa.slots, wb.slots)  # packed bytes
        assert a.count_misses(ls, valid=valid) == b.count_misses(ls, valid=valid)
        # refill every 3 steps (drives insertions AND evictions)
        if step % 3 == 2:
            uniq = [np.unique(ls[t]) for t in range(3)]
            rows = [master.gather(t, u) for t, u in enumerate(uniq)]
            a.plan_insert(uniq, rows)
            b.plan_insert(uniq, rows)
            for oa, ob in zip(a.occupancy, b.occupancy):
                np.testing.assert_array_equal(oa, ob)
    # checkpoint-load path: rebuild from occupancy must reproduce the map
    live = b._slot_map.copy()
    b.rebuild_slot_map()
    np.testing.assert_array_equal(live, b._slot_map)


def test_count_dedup_uniques_matches_probe_dedup(rng):
    """count_dedup_uniques (the window dedup-bucket negotiation primitive)
    must equal probe_dedup's sum(uniq_counts) exactly, with and without
    masks, map and setassoc probes, across refills."""
    ln_emb = (100, 7, 63)
    geo = CacheGeometry.build(ln_emb, 4, 10, 2, 64)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    for kw in ({}, dict(ln_emb=np.asarray(ln_emb), slot_map=True)):
        ctl = HostCacheController(geo, seed=5, **kw)
        for step in range(8):
            ls = np.stack([rng.integers(0, n, 24) for n in ln_emb])
            for valid in (None, rng.random((3, 24)) < 0.8):
                dr = ctl.probe_dedup(ls, master, inv_bits=9, valid=valid)
                assert ctl.count_dedup_uniques(ls, valid=valid) == int(
                    dr.uniq_counts.sum()
                ), (step, valid is None)
            if step % 3 == 2:
                uniq = [np.unique(ls[t]) for t in range(3)]
                rows = [master.gather(t, u) for t, u in enumerate(uniq)]
                ctl.plan_insert(uniq, rows)


def test_dedup_probe_aux_capacity_zero_raises(rng):
    """aux_capacity=0 (no aux region at all): a miss must raise the
    aux-capacity ValueError, not write the rank scratch out of bounds
    (review finding, round 2)."""
    geo = CacheGeometry.build((64,), 4, 8, 2, aux_capacity=0)
    ctl = HostCacheController(geo, seed=0)
    master = MasterTables((64,), 4, np.random.default_rng(0))
    with pytest.raises(ValueError, match="aux capacity"):
        ctl.probe_dedup(np.array([[5, 6, 7]], np.int64), master, inv_bits=9)


@pytest.mark.parametrize("masked", [False, True])
def test_slot_map_probe_rejects_out_of_range_ids(masked):
    """The flat direct map is segmented by table: an id >= ln_emb[t] in a
    non-last table would silently index the NEXT table's segment and could
    phantom-hit the wrong table's cache row. Every map path (probe,
    probe_wire, count_misses, count_probe_stats) must raise instead — except
    for MASKED padding lanes, which carry no input contract (the native
    kernel skips them)."""
    ln_emb = (50, 40, 30)
    geo = CacheGeometry.build(ln_emb, 4, 8, 2, 16)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    ctl = HostCacheController(geo, seed=1, ln_emb=np.asarray(ln_emb),
                              slot_map=True)
    ls = np.stack([np.arange(4, dtype=np.int64) for _ in ln_emb])
    ls[1, 2] = 45  # >= ln_emb[1], but < ln_emb[0]: lands in table 2's segment
    if masked:
        valid = np.ones((3, 4), bool)
        valid[1, 2] = False  # the OOB id is a masked padding lane: accepted
        ctl.probe(ls, master, valid=valid)
        ctl.probe_wire(ls, master, bits=9, valid=valid)
        ctl.count_misses(ls, valid=valid)
        ctl.count_probe_stats(ls, valid=valid)
    else:
        with pytest.raises(ValueError, match="out of range"):
            ctl.probe(ls, master)
        with pytest.raises(ValueError, match="out of range"):
            ctl.probe_wire(ls, master, bits=9)
        with pytest.raises(ValueError, match="out of range"):
            ctl.count_misses(ls)
        with pytest.raises(ValueError, match="out of range"):
            ctl.count_probe_stats(ls)


@pytest.mark.parametrize("slot_map", [False, True])
def test_apply_plan_spec_equivalent_to_plan_insert(slot_map):
    """The shadow-planner contract: plan_insert_spec on a clone + trainer-side
    apply_plan_spec must leave the trainer controller in EXACTLY the state a
    direct plan_insert would have (occupancy, slot map, RNG state), and the
    joined InsertPlan must be identical — across several windows with
    evictions."""
    ln_emb = (100, 7, 63)
    rng = np.random.default_rng(3)
    geo = CacheGeometry.build(ln_emb, 4, 10, 2, 32)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    kw = dict(ln_emb=np.asarray(ln_emb), slot_map=True) if slot_map else {}
    direct = HostCacheController(geo, seed=7, **kw)
    live = HostCacheController(geo, seed=7, **kw)
    shadow = live.clone()
    for _ in range(6):
        ls = np.stack([rng.integers(0, n, 40) for n in ln_emb])
        uniq = [np.unique(ls[t]) for t in range(3)]
        rows = [master.gather(t, u) for t, u in enumerate(uniq)]
        want = direct.plan_insert(uniq, rows)
        spec = shadow.plan_insert_spec(uniq)
        live.apply_plan_spec(spec)
        from cdlrm_tpu.cache.host_cache import build_insert_plan

        got = build_insert_plan(spec, rows, geo.dim)
        np.testing.assert_array_equal(got.insert_slots, want.insert_slots)
        np.testing.assert_allclose(got.insert_rows, want.insert_rows)
        np.testing.assert_array_equal(got.evict_slots, want.evict_slots)
        np.testing.assert_array_equal(got.evict_tables, want.evict_tables)
        np.testing.assert_array_equal(got.evict_idxs, want.evict_idxs)
        for a, b, c in zip(direct.occupancy, live.occupancy, shadow.occupancy):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        if slot_map:
            np.testing.assert_array_equal(direct._slot_map, live._slot_map)
            np.testing.assert_array_equal(direct._slot_map, shadow._slot_map)
        # state dicts hold arrays; equality via identical next draws
        assert live.rng.random() == direct.rng.random() == shadow.rng.random()
        # live probes must agree after replay (phantom-hit guard)
        pa = direct.probe(ls, master)
        pb = live.probe(ls, master)
        np.testing.assert_array_equal(pa.slots, pb.slots)


@pytest.mark.parametrize("use_valid", [False, True])
def test_slot_map_dedup_probe_bit_identical(use_valid):
    """The fused map dedup probe (native cdlrm_map_probe_batch_dedup) and
    the raw (unpacked) variant must be bit-identical to the occupancy-walk
    dedup probe across probes and refills — inv wire, unique lists, counts,
    aux assignment."""
    ln_emb = (100, 7, 63)
    rng = np.random.default_rng(21)
    geo = CacheGeometry.build(ln_emb, 4, 10, 2, 32)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    a = HostCacheController(geo, seed=5)
    b = HostCacheController(geo, seed=5, ln_emb=np.asarray(ln_emb),
                            slot_map=True)
    for step in range(10):
        ls = np.stack([rng.integers(0, n, 24) for n in ln_emb])
        valid = (rng.random((3, 24)) < 0.8) if use_valid else None
        da = a.probe_dedup(ls, master, inv_bits=9, valid=valid)
        db = b.probe_dedup(ls, master, inv_bits=9, valid=valid)
        np.testing.assert_array_equal(da.inv_wire, db.inv_wire)
        np.testing.assert_array_equal(da.uniq, db.uniq)
        np.testing.assert_array_equal(da.uniq_counts, db.uniq_counts)
        np.testing.assert_array_equal(da.aux_slots, db.aux_slots)
        np.testing.assert_allclose(da.aux_rows, db.aux_rows)
        assert da.hit_counts.tolist() == db.hit_counts.tolist()
        ra = a.probe_dedup_raw(ls, master, valid=valid)
        rb = b.probe_dedup_raw(ls, master, valid=valid)
        np.testing.assert_array_equal(ra.inv_wire, rb.inv_wire)
        np.testing.assert_array_equal(ra.uniq, rb.uniq)
        assert ra.inv_wire.dtype == np.int32 and ra.inv_wire.shape == ls.shape
        if step % 3 == 2:
            uniq = [np.unique(ls[t]) for t in range(3)]
            rows = [master.gather(t, u) for t, u in enumerate(uniq)]
            a.plan_insert(uniq, rows)
            b.plan_insert(uniq, rows)


@pytest.mark.parametrize("use_valid", [False, True])
def test_probe_dedup_raw_sorted(use_valid):
    """sort=True (Config.sorted_dedup_wire) must emit ascending unique
    slots while every lane still resolves to the same slot as the
    first-seen-order wire — a pure permutation of bucket positions."""
    ln_emb = (100, 7, 63)
    rng = np.random.default_rng(33)
    geo = CacheGeometry.build(ln_emb, 4, 10, 2, 32)
    master = MasterTables(ln_emb, 4, np.random.default_rng(0))
    ctrl = HostCacheController(geo, seed=5)
    base = np.zeros(3, np.int64)
    for step in range(6):
        ls = np.stack([rng.integers(0, n, 24) for n in ln_emb])
        valid = (rng.random((3, 24)) < 0.8) if use_valid else None
        ref = ctrl.probe_dedup_raw(ls, master, valid=valid)
        srt = ctrl.probe_dedup_raw(ls, master, valid=valid, sort=True)
        # ascending globally (table blocks are disjoint ascending)
        assert np.all(np.diff(srt.uniq) > 0)
        np.testing.assert_array_equal(np.sort(ref.uniq), srt.uniq)
        np.testing.assert_array_equal(ref.uniq_counts, srt.uniq_counts)
        np.testing.assert_array_equal(ref.aux_slots, srt.aux_slots)
        # per-lane resolved slots identical under either rank layout
        base[1:] = np.cumsum(ref.uniq_counts[:-1])
        for t in range(3):
            lanes = np.flatnonzero(valid[t]) if use_valid else np.arange(24)
            a = ref.uniq[base[t] + ref.inv_wire[t, lanes]]
            b = srt.uniq[base[t] + srt.inv_wire[t, lanes]]
            np.testing.assert_array_equal(a, b)
            masked = np.setdiff1d(np.arange(24), lanes)
            assert np.all(ref.inv_wire[t, masked] == -1)
            assert np.all(srt.inv_wire[t, masked] == -1)
        if step % 2 == 1:
            uniq = [np.unique(ls[t]) for t in range(3)]
            rows = [master.gather(t, u) for t, u in enumerate(uniq)]
            ctrl.plan_insert(uniq, rows)
