"""Training CLI — the reference's launcher surface
(/root/reference/main_no_ddp.py:505-646) as a single-controller entry point.

Example (tiny, CPU-runnable):
  python -m cdlrm_tpu.cli --data-generation random --arch-embedding-size \
    1000-500-2000 --arch-sparse-feature-size 16 --arch-mlp-bot 13-32-16 \
    --arch-mlp-top 16-8-1 --mini-batch-size 64 --num-batches 100 \
    --cache-size 128 --num-ways 4 --loss-function bce --lookahead 8 \
    --world-size 1 --print-freq 20

Paper-repro example (reference README.md:7 flags map 1:1):
  python -m cdlrm_tpu.cli --data-generation dataset --data-set terabyte ...
"""

from __future__ import annotations

import sys

import numpy as np

from cdlrm_tpu.config import Config, config_from_args


def build_dataset(cfg: Config):
    """Returns (train_ds, test_ds, cfg) with cfg.finalize() applied."""
    if cfg.data_generation in ("random", "synthetic"):
        cfg.finalize()
        from cdlrm_tpu.data.synthetic import SyntheticDataset

        train = SyntheticDataset(
            m_den=cfg.ln_bot[0],
            ln_emb=cfg.ln_emb,
            data_size=cfg.data_size,
            mini_batch_size=cfg.mini_batch_size,
            num_batches=cfg.num_batches,
            num_indices_per_lookup=cfg.num_indices_per_lookup,
            num_indices_per_lookup_fixed=cfg.num_indices_per_lookup_fixed,
            round_targets=cfg.round_targets,
            data_generation=cfg.data_generation,
            trace_file=cfg.data_trace_file,
            enable_padding=cfg.data_trace_enable_padding,
            trace_model=cfg.data_trace_model,
            seed=cfg.numpy_rand_seed,
        )
        test = SyntheticDataset(
            m_den=cfg.ln_bot[0],
            ln_emb=cfg.ln_emb,
            data_size=max(cfg.test_mini_batch_size * 4, cfg.mini_batch_size),
            mini_batch_size=cfg.test_mini_batch_size,
            # eval batches must share the train stream's pooled width: the
            # trainer compiles one eval step for [T, B, P] + mask
            num_indices_per_lookup=cfg.num_indices_per_lookup,
            num_indices_per_lookup_fixed=cfg.num_indices_per_lookup_fixed,
            round_targets=cfg.round_targets,
            data_generation=cfg.data_generation,
            trace_file=cfg.data_trace_file,
            enable_padding=cfg.data_trace_enable_padding,
            trace_model=cfg.data_trace_model,
            seed=cfg.numpy_rand_seed + 1,
        )
        return train, test, cfg
    if cfg.data_generation == "dataset":
        from cdlrm_tpu.data.criteo import make_criteo_datasets

        return make_criteo_datasets(cfg)
    raise ValueError(f"unsupported --data-generation {cfg.data_generation}")


def main(argv=None) -> int:
    from cdlrm_tpu.utils.device import enable_compile_cache

    cfg = config_from_args(argv)
    enable_compile_cache()
    np.set_printoptions(precision=cfg.print_precision)

    if cfg.coordinator_address:
        # multi-host launch: one process per host (parallel/multihost.py);
        # the reference is single-node-only (main_no_ddp.py:341)
        from cdlrm_tpu.parallel.multihost import initialize_distributed

        pid, nproc = initialize_distributed(
            cfg.coordinator_address,
            cfg.num_hosts if cfg.num_hosts > 0 else None,
            cfg.host_id if cfg.host_id >= 0 else None,
        )
        print(f"[multihost] process {pid}/{nproc} initialized")

    train_ds, test_ds, cfg = build_dataset(cfg)

    if cfg.use_cache:
        from cdlrm_tpu.train.trainer import CachedDlrmTrainer

        trainer = CachedDlrmTrainer(cfg, train_ds, test_ds)
    else:
        from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer

        trainer = FullTableDlrmTrainer(cfg, train_ds, test_ds)

    if cfg.load_model:
        trainer.load_checkpoint(cfg.load_model)
    from cdlrm_tpu.utils.profiling import profile_trace

    try:
        with profile_trace(cfg.profile_dir if cfg.enable_profiling else None):
            if not cfg.inference_only:
                trainer.train(
                    max_steps=cfg.num_batches if cfg.num_batches > 0 else None
                )
        if test_ds is not None:
            trainer.evaluate()
        if cfg.save_model and not cfg.inference_only:
            trainer.save_checkpoint(cfg.save_model)
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
