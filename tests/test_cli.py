"""CLI surface: reference-style invocations end-to-end (random mode and
dataset mode with on-the-fly preprocessing of a fabricated Kaggle raw file)."""

import numpy as np
import pytest

from cdlrm_tpu import cli
from tests.test_data_criteo import write_raw_kaggle


def test_cli_random_cached(capsys):
    rc = cli.main(
        [
            "--data-generation", "random",
            "--arch-embedding-size", "500-200-800",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "32",
            "--num-batches", "12",
            "--data-size", "384",
            "--cache-size", "64",
            "--num-ways", "2",
            "--loss-function", "bce",
            "--lookahead", "4",
            "--world-size", "8",
            "--print-freq", "5",
            "--num-indices-per-lookup", "1",
            "--num-indices-per-lookup-fixed",
            "--round-targets",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "hit-rate" in out
    assert "Test accuracy" in out


def test_cli_dataset_kaggle_memory_map(tmp_path, capsys):
    raw = str(tmp_path / "train.txt")
    write_raw_kaggle(raw, n=120)
    rc = cli.main(
        [
            "--data-generation", "dataset",
            "--data-set", "kaggle",
            "--raw-data-file", raw,
            "--memory-map",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "16",
            "--num-batches", "5",
            "--cache-size", "32",
            "--num-ways", "2",
            "--loss-function", "bce",
            "--lookahead", "2",
            "--world-size", "8",
            "--print-freq", "2",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "Test accuracy" in out


def test_cli_dataset_checkpoint_roundtrip(tmp_path, capsys):
    raw = str(tmp_path / "train.txt")
    write_raw_kaggle(raw, n=120)
    common = [
        "--data-generation", "dataset",
        "--data-set", "kaggle",
        "--raw-data-file", raw,
        "--memory-map",
        "--arch-sparse-feature-size", "8",
        "--arch-mlp-bot", "13-16-8",
        "--arch-mlp-top", "8-1",
        "--mini-batch-size", "16",
        "--num-batches", "4",
        "--cache-size", "32",
        "--num-ways", "2",
        "--lookahead", "2",
        "--world-size", "8",
        "--print-freq", "100",
    ]
    ck = str(tmp_path / "ckpt")
    assert cli.main(common + ["--save-model", ck]) == 0
    assert cli.main(common + ["--load-model", ck]) == 0


def test_cli_fulltable_qr(capsys):
    """QR-compressed embeddings end-to-end on the uncached path (the only
    path where the reference's tricks actually work — models/tricks.py)."""
    rc = cli.main(
        [
            "--data-generation", "random",
            "--no-use-cache",
            "--qr-flag", "--qr-threshold", "300", "--qr-collisions", "4",
            "--arch-embedding-size", "500-200-800",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "32",
            "--num-batches", "8",
            "--data-size", "256",
            "--loss-function", "bce",
            "--world-size", "8",
            "--print-freq", "4",
            "--num-indices-per-lookup", "1",
            "--num-indices-per-lookup-fixed",
            "--round-targets",
        ]
    )
    assert rc == 0
    assert "Test accuracy" in capsys.readouterr().out


def test_cli_fulltable_md_multihot(capsys):
    """Mixed-dimension embeddings + padded multi-hot bags end-to-end."""
    rc = cli.main(
        [
            "--data-generation", "random",
            "--no-use-cache",
            "--md-flag", "--md-threshold", "300",
            "--arch-embedding-size", "500-200-800",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "32",
            "--num-batches", "8",
            "--data-size", "256",
            "--loss-function", "bce",
            "--world-size", "8",
            "--print-freq", "4",
            "--num-indices-per-lookup", "3",
            "--round-targets",
        ]
    )
    assert rc == 0
    assert "Test accuracy" in capsys.readouterr().out


def test_cli_nepochs_and_profiling(tmp_path, capsys):
    """Multi-epoch stream (prefetcher + pipeline epoch loops stay aligned)
    with a real jax.profiler trace (the flag the reference never wired)."""
    trace_dir = str(tmp_path / "trace")
    rc = cli.main(
        [
            "--data-generation", "random",
            "--arch-embedding-size", "300-150",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "32",
            "--data-size", "192",  # 6 batches/epoch
            "--nepochs", "3",
            "--cache-size", "64",
            "--num-ways", "2",
            "--loss-function", "bce",
            "--lookahead", "3",
            "--world-size", "8",
            "--print-freq", "6",
            "--num-indices-per-lookup", "1",
            "--num-indices-per-lookup-fixed",
            "--round-targets",
            "--enable-profiling", "--profile-dir", trace_dir,
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "Step 18" in out  # 3 epochs x 6 batches all trained
    import os

    assert os.path.isdir(trace_dir) and os.listdir(trace_dir)


def write_learnable_kaggle(path, n=4096, seed=0):
    """Raw Kaggle-format TSV whose target is a deterministic threshold on a
    dense feature — learnable well past the reference's Kaggle stop
    threshold (0.789, main_no_ddp.py:117-118)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            dense = rng.integers(0, 100, 13)
            cats = rng.integers(0, 50, 26)
            target = int(dense[0] > 50)
            f.write(
                "\t".join(
                    [str(target)]
                    + [str(int(v)) for v in dense]
                    + [format(int(v), "x") for v in cats]
                )
                + "\n"
            )


@pytest.mark.slow
def test_convergence_proxy_mlperf_early_stop(tmp_path, capsys):
    """Convergence proxy through the REAL CLI: train on
    a learnable fabricated Kaggle stream until the MLPerf accuracy early
    stop fires (reference stop semantics, main_no_ddp.py:117-118 +
    :479-505), checkpoint at the stop, then resume from the checkpoint in a
    second CLI invocation and confirm the threshold trips again
    immediately."""
    raw = str(tmp_path / "train.txt")
    write_learnable_kaggle(raw, n=4096)
    ck = str(tmp_path / "ckpt")
    common = [
        "--data-generation", "dataset",
        "--data-set", "kaggle",
        "--raw-data-file", raw,
        "--memory-map",
        "--arch-sparse-feature-size", "8",
        "--arch-mlp-bot", "13-32-8",
        "--arch-mlp-top", "8-4-1",
        "--mini-batch-size", "64",
        "--cache-size", "64",
        "--num-ways", "4",
        "--loss-function", "bce",
        "--lookahead", "4",
        "--world-size", "8",
        "--learning-rate", "0.05",
        "--lr-embeds", "0.05",
        "--print-freq", "40",
        "--test-freq", "40",
        "--nepochs", "40",
        "--mlperf-acc-threshold", "0.80",
        "--round-targets",
    ]
    rc = cli.main(common + ["--save-model", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert "MLPerf threshold reached" in out  # early stop fired
    # resumed run: loads the converged state, first eval re-trips the stop
    rc = cli.main(common + ["--load-model", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert "MLPerf threshold reached" in out


def test_cli_inference_only(tmp_path, capsys):
    """--inference-only (the reference parses it but never uses it,
    main_no_ddp.py:140): train+save in one invocation, then an eval-only
    invocation from the checkpoint — no training steps, test metrics
    printed."""
    raw = str(tmp_path / "train.txt")
    write_raw_kaggle(raw, n=120)
    common = [
        "--data-generation", "dataset",
        "--data-set", "kaggle",
        "--raw-data-file", raw,
        "--memory-map",
        "--arch-sparse-feature-size", "8",
        "--arch-mlp-bot", "13-16-8",
        "--arch-mlp-top", "8-1",
        "--mini-batch-size", "16",
        "--cache-size", "32",
        "--num-ways", "2",
        "--lookahead", "2",
        "--world-size", "8",
        "--print-freq", "100",
    ]
    ck = str(tmp_path / "ckpt")
    assert cli.main(common + ["--num-batches", "4", "--save-model", ck]) == 0
    capsys.readouterr()
    assert cli.main(common + ["--inference-only", "--load-model", ck]) == 0
    out = capsys.readouterr().out
    assert "Test accuracy" in out
    assert "ms/it" not in out  # no training windows ran


def test_cli_mlperf_bin_loader_end_to_end(tmp_path, capsys):
    """C16 through the real CLI: raw TSV -> offline preprocessing ->
    numpy_to_binary -> --mlperf-bin-loader with seeded shuffle and parallel
    batch fetch (--num-workers), training + eval end to end (reference
    wiring: dlrm_data_pytorch.py:391-439)."""
    import os

    from cdlrm_tpu.data.criteo import numpy_to_binary
    from cdlrm_tpu.data.preprocess import get_criteo_ad_data

    raw = str(tmp_path / "train.txt")
    write_raw_kaggle(raw, n=240)
    prefix = get_criteo_ad_data(
        raw, "kaggle_processed", days=7, criteo_kaggle=True, memory_map=True
    )
    d = str(tmp_path)
    numpy_to_binary(
        [f"{prefix}_{i}_reordered.npz" for i in range(6)],
        os.path.join(d, "train_data.bin"), split="train",
    )
    numpy_to_binary(
        [f"{prefix}_6_reordered.npz"],
        os.path.join(d, "test_data.bin"), split="test",
    )
    rc = cli.main(
        [
            "--data-generation", "dataset",
            "--data-set", "kaggle",
            "--raw-data-file", raw,
            "--processed-data-file", os.path.join(d, "ignored.npz"),
            "--mlperf-bin-loader",
            "--mlperf-bin-shuffle",
            "--num-workers", "2",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "16",
            "--cache-size", "32",
            "--num-ways", "2",
            "--loss-function", "bce",
            "--lookahead", "2",
            "--world-size", "8",
            "--print-freq", "2",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "Test accuracy" in out


def test_metrics_log_json_lines(tmp_path, capsys):
    """--metrics-log appends structured JSON lines (train windows + eval) —
    the observability upgrade over the reference's print-only reporting
    (SURVEY.md §5 'Metrics / logging')."""
    import json

    # nested path: the trainer must create missing parent directories
    # (round-3 advisor finding)
    log = str(tmp_path / "logs" / "metrics.jsonl")
    rc = cli.main(
        [
            "--data-generation", "random",
            "--arch-embedding-size", "300-200-400",
            "--arch-sparse-feature-size", "8",
            "--arch-mlp-bot", "13-16-8",
            "--arch-mlp-top", "8-1",
            "--mini-batch-size", "16",
            "--num-batches", "14",
            "--data-size", "224",
            "--cache-size", "32",
            "--num-ways", "2",
            "--loss-function", "bce",
            "--lookahead", "4",
            "--world-size", "8",
            "--print-freq", "4",
            "--num-indices-per-lookup", "1",
            "--num-indices-per-lookup-fixed",
            "--round-targets",
            "--metrics-log", log,
        ]
    )
    assert rc == 0
    records = [json.loads(line) for line in open(log)]
    kinds = {r["kind"] for r in records}
    assert "train_window" in kinds and "eval" in kinds
    n_tables = 3  # --arch-embedding-size 300-200-400
    for r in records:
        assert "step" in r
        if r["kind"] == "train_window":
            assert {"ms_per_iter", "loss", "accuracy", "hit_rate",
                    "dedup", "per_table_hit_rates"} <= set(r)
        else:
            assert {"accuracy", "auc", "eval_hit_rate",
                    "per_table_hit_rates"} <= set(r)
        # the flagship first-class metric rides in the structured payload:
        # [T] floats in [0, 1] once any train probe has been counted
        ptr = r["per_table_hit_rates"]
        if ptr is not None:
            assert len(ptr) == n_tables
            assert all(0.0 <= v <= 1.0 for v in ptr)
    # at least one record must carry real per-table rates
    assert any(r["per_table_hit_rates"] for r in records)
