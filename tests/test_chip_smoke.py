"""chip_smoke.py and the benchmarks' accelerator gate, as far as a machine
without a GPU can check them: they refuse to run, print no result line,
and choose the right phases and geometry. The phases themselves run on the
card (``python chip_smoke.py``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=cwd,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_smoke_fails_without_gpu(args):
    p = _run_smoke(REPO, *args)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_smoke(str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_contract(count):
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }
    assert "\n" not in line


def test_four_cards_selects_only_its_phase():
    assert chip_smoke.phases_for(True) == ["device", "data_parallel"]
    one = chip_smoke.phases_for(False)
    assert "data_parallel" not in one
    assert one == ["device", "kernels", "main_path", "reference"]
    assert chip_smoke.parse_args(["--four-cards"]).four_cards
    assert not chip_smoke.parse_args([]).four_cards


def test_main_path_arms_run_the_three_step_bodies():
    """Arm (b) resolves block coalescing on (body_coalesce), arm (c) runs
    the dedup wire with AdaGrad (body_dedup), arm (a) stays on defaults;
    every arm is at the paper widths."""
    from cdlrm_tpu.config import config_from_args

    cfgs = {
        arm: config_from_args(
            chip_smoke.main_path_argv(arm, "m.jsonl", 1, 48)).finalize()
        for arm in ("a_default", "b_coalesce", "c_adagrad")
    }
    for cfg in cfgs.values():
        assert cfg.arch_sparse_feature_size == 128
        assert cfg.ln_bot == [13, 512, 256, 128]
        assert cfg.ln_top[1:] == [512, 512, 256, 1]
        assert len(cfg.ln_emb) == 26 and set(cfg.ln_emb) == {250_000}
        assert cfg.mini_batch_size == 4096
    assert cfgs["a_default"].pack_wire and cfgs["a_default"].dedup_lookups == "auto"
    assert cfgs["b_coalesce"].block_coalesced_update is True
    assert cfgs["c_adagrad"].optimizer == "adagrad"
    assert cfgs["c_adagrad"].block_coalesced_update is False


def test_check_arm_rejects_a_run_without_writebacks():
    win = {"kind": "train_window", "loss": 0.7, "hit_rate": 0.9,
           "rows_written": 0, "refills": 3, "steps": 8, "ms_per_iter": 5.0,
           "dedup": False}
    ev = {"kind": "eval", "accuracy": 0.5, "auc": 0.5}
    with pytest.raises(AssertionError, match="rows_written"):
        chip_smoke.check_arm("x", [win, ev])
    rec = chip_smoke.check_arm("x", [win, dict(win, rows_written=5), ev])
    assert rec["rows_written"] == 5


def test_resident_geometry_is_fully_resident():
    from cdlrm_tpu.config import config_from_args

    cfg = config_from_args(
        chip_smoke.resident_argv(4, 250_000, 12, 1, "delta")).finalize()
    assert all(int(n) <= cfg.cache_sets for n in cfg.ln_emb)
    assert cfg.refill_broadcast == "delta"  # agg freq 1 divides lookahead
    assert cfg.mini_batch_size == 4 * 4096


@pytest.mark.parametrize("flag", [
    "--use-pallas-lookup", "--use-pallas-scatter", "--pallas-interpret",
])
def test_removed_kernel_flags_are_rejected(flag, capsys):
    from cdlrm_tpu.config import config_from_args

    with pytest.raises(SystemExit):
        config_from_args([flag])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("backend,cpu_ok", [
    ("cpu", False), ("rocm", False), ("rocm", True),
])
def test_bench_geometry_needs_an_accelerator(backend, cpu_ok):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.resolve_geometry(backend, cpu_ok)


def test_bench_geometry_on_gpu_is_headline():
    geo = bench.resolve_geometry("gpu", cpu_ok=False)
    assert geo == bench.HEADLINE_GEOMETRY
    assert (geo["num_tables"], geo["table_rows"], geo["dim"],
            geo["batch"]) == (26, 250_000, 128, 4096)
    # a GPU always measures at the headline geometry, even with BENCH_CPU
    assert bench.resolve_geometry("gpu", cpu_ok=True) == geo
    assert bench.resolve_geometry("cpu", cpu_ok=True) == bench.DEBUG_GEOMETRY
