"""The cached step's plain sparse operations — XLA's gather, scatter-add and
scatter-set — against numpy at the production row width (D=128), and the
byte model the kernel benchmark divides their times by (bench_kernels.py;
the card's times come from ``python chip_smoke.py``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench_kernels  # noqa: E402

R, D = 4096, 128


def _slots(rng, n, distinct):
    if distinct:
        return rng.choice(R - 1, n, replace=False).astype(np.int32)
    return rng.integers(0, 64, n).astype(np.int32)  # heavy duplication


@pytest.mark.parametrize("distinct", [True, False])
def test_gather_matches_numpy(rng, distinct):
    cache = rng.standard_normal((R, D), dtype=np.float32)
    slots = _slots(rng, 2048, distinct)
    out = jax.jit(lambda c, s: jnp.take(c, s, axis=0))(cache, slots)
    np.testing.assert_array_equal(np.asarray(out), cache[slots])


def test_distinct_scatter_add_is_bit_exact(rng):
    """The dedup wire's contract: distinct destination rows, so every
    element sees exactly one f32 add — bit-exact against numpy whatever
    order the device applies the rows in."""
    cache = rng.standard_normal((R, D), dtype=np.float32)
    slots = _slots(rng, 1024, True)
    delta = rng.standard_normal((1024, D), dtype=np.float32)
    out = np.asarray(jax.jit(lambda c, s, g: c.at[s].add(g))(
        cache, slots, delta))
    want = cache.copy()
    want[slots] += delta
    np.testing.assert_array_equal(out, want)


def test_duplicate_scatter_add_matches_add_at(rng):
    """Duplicate slots (the plain wire) accumulate every update; the
    summation order is unspecified (atomics on a GPU), so f32 tolerance."""
    cache = rng.standard_normal((R, D), dtype=np.float32)
    slots = _slots(rng, 2048, False)
    delta = rng.standard_normal((2048, D), dtype=np.float32)
    out = np.asarray(jax.jit(lambda c, s, g: c.at[s].add(g))(
        cache, slots, delta))
    want = cache.astype(np.float64)
    np.add.at(want, slots, delta.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("pad", [0, 256])
def test_insert_set_matches_numpy(rng, pad):
    """Refill insert / aux staging: distinct rows set, with the bucket's
    padding aimed at the trash row (last row, unspecified by contract)."""
    cache = rng.standard_normal((R, D), dtype=np.float32)
    slots = np.concatenate([
        _slots(rng, 512, True), np.full(pad, R - 1, np.int32)])
    rows = rng.standard_normal((slots.size, D), dtype=np.float32)
    out = np.asarray(jax.jit(lambda c, s, v: c.at[s].set(v))(
        cache, slots, rows))
    want = cache.copy()
    want[slots[:512]] = rows[:512]
    np.testing.assert_array_equal(out[:-1], want[:-1])


def test_gather_vjp_is_duplicate_scatter_add(rng):
    """The sparse gradient of the lookup: take's transpose sums the
    per-lookup gradients of repeated rows (np.add.at)."""
    cache = rng.standard_normal((256, D), dtype=np.float32)
    slots = rng.integers(0, 256, 1024).astype(np.int32)
    g = np.asarray(jax.grad(
        lambda c: jnp.sum(jnp.take(c, slots, axis=0) ** 2))(cache))
    want = np.zeros((256, D), np.float64)
    np.add.at(want, slots, 2.0 * cache[slots].astype(np.float64))
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,n,mbytes", [
    ("gather", 26 * 4096, 109.05),  # 106,496 rows read + written
    ("scatter_add", 65_536, 100.66),  # delta + rows read, rows written
    ("set", 65_536, 67.11),
])
def test_sparse_byte_model(kind, n, mbytes):
    assert bench_kernels.sparse_bytes(kind, n, 128) / 1e6 == pytest.approx(
        mbytes, abs=0.01)


def test_sparse_kernel_rows_smoke():
    """bench_kernels' sparse rows at the smoke shapes: each is checked
    against numpy inside and carries a time and a rate; no roofline share
    without a device peak."""
    recs = bench_kernels.time_sparse_kernels(smoke=True)
    names = [r["kernel"].split("/")[0] for r in recs]
    assert names == ["lookup_gather", "uniq_scatter_add", "insert_set"]
    for r in recs:
        assert r["us"] > 0 and r["gbps"] > 0
        assert "roofline_frac" not in r


def test_sparse_kernel_rows_roofline_share():
    recs = bench_kernels.time_sparse_kernels(smoke=True, peak_gbps=1000.0)
    for r in recs:
        # least time at the peak rate, and the share of it achieved
        assert r["roofline_us"] == pytest.approx(r["bytes"] / 1e6, abs=0.01)
        assert r["roofline_frac"] == pytest.approx(
            r["roofline_us"] / r["us"], abs=1e-3)
