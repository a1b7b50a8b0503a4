"""Bitrot guards for the benchmark harnesses.

The harnesses measure on a GPU and refuse to run without one; a harness
that stopped importing or crashed at startup would spend chip time on a
traceback. Each harness exposes a CPU smoke mode (env-forced
`jax_platforms=cpu` in-process); these tests run them at the tiniest
geometry and assert the final stdout line is the JSON contract.
Harnesses without a CPU mode get compile-only guards.
"""

import json
import os
import py_compile
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(env_extra, script, timeout=300):
    env = dict(os.environ, **env_extra)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, script)],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [l for l in p.stdout.strip().splitlines() if l.strip()]
    assert lines, f"{script}: no stdout"
    return [json.loads(l) for l in lines if l.lstrip().startswith("{")]


@pytest.mark.slow
def test_block_ab_cpu_smoke():
    out = _run(
        {"BLOCKAB_CPU": "1", "BLOCKAB_TABLES": "2", "BLOCKAB_IDS": "500",
         "BLOCKAB_BATCH": "32", "BLOCKAB_CACHE_ROWS": "2048"},
        "bench_block_ab.py",
    )
    # one JSON line per stream, each carrying the A/B ratio
    assert len(out) >= 2
    for rec in out:
        assert "B_over_A" in rec and rec["B_over_A"] > 0


@pytest.mark.slow
def test_pressure_cpu_smoke():
    out = _run(
        {"PRESSURE_CPU": "1", "PRESSURE_TABLES": "2", "PRESSURE_IDS": "600",
         "PRESSURE_DIM": "8", "PRESSURE_BATCH": "32", "PRESSURE_STEPS": "12"},
        "bench_pressure.py", timeout=600,
    )
    rec = out[-1]
    assert rec["metric"] == "pressure_auc_gap"
    assert "oracle" in rec and "cached" in rec
    assert rec["pressure_real"] is False  # smoke geometry, flagged honestly


@pytest.mark.slow
def test_serving_ab_cpu_smoke():
    out = _run({"SERVINGAB_CPU": "1"}, "bench_serving_ab.py", timeout=600)
    rec = out[-1]
    assert rec["metric"] == "serving_pipeline_ab"
    assert rec["serial_examples_per_sec"] > 0
    assert rec["pipelined_examples_per_sec"] > 0


@pytest.mark.slow
def test_bench_cpu_smoke():
    """The headline artifact end-to-end (BENCH_CPU forces the backend
    in-process): asserts the FULL JSON contract the driver records —
    headline + device step + serving + steady-state regime — so a bench.py
    regression cannot wait for chip time to surface."""
    out = _run({"BENCH_CPU": "1"}, "bench.py", timeout=900)
    rec = out[-1]
    assert rec["metric"] == "cached_dlrm_train_examples_per_sec_per_chip"
    for key in ("value", "unit", "vs_baseline", "hit_rate", "ms_per_iter",
                "device_step_ms", "eval_examples_per_sec",
                "steady_state_examples_per_sec",
                "steady_state_caching_overhead_ms_per_iter",
                "h2d_bytes_per_step"):
        assert key in rec, key
    assert rec["value"] > 0 and rec["device_step_ms"] > 0
    assert rec["backend"] == "cpu"
    # the steady-state regime must actually contain refill boundaries
    assert rec["steady_refills"] >= 3


@pytest.mark.slow
def test_bench_cpu_smoke_block_coalesce_ab():
    """The block-coalesce chip A/B harness end-to-end on CPU: with the
    unpacked dedup wire, block_coalesced_update='auto' must resolve ON,
    the scan-block metric must be emitted, and BENCH_BLOCK=0 must produce
    the control arm — the A/B pair run on the card."""
    knobs = {"BENCH_CPU": "1", "BENCH_SKIP_EXTRAS": "1",
             "BENCH_DEDUP": "on", "BENCH_PACK": "0"}
    rec = _run(knobs, "bench.py", timeout=900)[-1]
    assert rec["block_coalesced"] is True
    assert rec["block_step_ms_per_iter"] > 0
    assert rec["block_union_host_ms"] >= 0
    rec0 = _run(dict(knobs, BENCH_BLOCK="0"), "bench.py", timeout=900)[-1]
    assert rec0["block_coalesced"] is False
    assert rec0["block_step_ms_per_iter"] > 0


@pytest.mark.slow
def test_step_breakdown_cpu_smoke():
    """The step-breakdown harness end-to-end on tiny
    CPU shapes: every component row carries a timing and the summary
    carries the accounted sums."""
    out = _run({"BREAKDOWN_CPU": "1"}, "bench_step_breakdown.py",
               timeout=600)
    rec = out[-1]
    assert rec["metric"] == "step_breakdown"
    for c in ("gather_uniq", "expand_take", "pend_scatter",
              "cache_scatter", "flush_scatter", "dense_fwdbwd"):
        assert rec["components"][c] > 0, c
    assert rec["sum_components_coalesced_ms"] > 0
    assert rec["sum_components_perstep_ms"] > 0


@pytest.mark.slow
def test_kernels_cpu_smoke():
    """The kernel harness end-to-end (KERNELS_CPU: scaled shapes): every
    kernel entry must carry a timing, none may be an error record."""
    out = _run({"KERNELS_CPU": "1"}, "bench_kernels.py", timeout=600)
    assert len(out) >= 10
    names = {rec["kernel"] for rec in out}
    for prefix in ("lookup_gather/xla", "uniq_scatter_add/xla",
                   "insert_set/xla"):
        assert any(n.startswith(prefix) for n in names), prefix
    for rec in out:
        assert "error" not in rec, rec
        assert any(k in rec for k in ("us", "ms")), rec


def test_chip_queue_harnesses_compile():
    """Every harness and the chip smoke stay compile-guarded in the fast
    suite (the full CPU smoke runs above are marked slow)."""
    for script in ("bench.py", "bench_kernels.py", "bench_scaling.py",
                   "bench_collectives.py", "chip_smoke.py"):
        py_compile.compile(os.path.join(REPO, script), doraise=True)
