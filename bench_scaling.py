"""Multi-host scaling benchmark: examples/s at 1 process vs H processes.

Measures the BASELINE.json north-star metric (">=80% examples/s scaling
efficiency 1 -> 2 hosts") by running the REAL multi-host trainer
(jax.distributed + row-sharded masters + window exchange,
parallel/multihost.py) as an H-process cluster.

With --backend gpu each spawned process owns a disjoint set of cards through
CUDA_VISIBLE_DEVICES (one process per card group: a JAX process reserves
most of the memory of every card it can see, so two processes must never
share one). Without hardware this driver spawns local CPU-device processes
(Gloo collectives) — correctness-faithful, but on a single shared machine
the processes contend for the same cores, so CPU numbers are a lower bound
on real scaling, not a measurement of it (printed as such).

Prints ONE JSON line per topology plus a final efficiency line.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_WORKER = r"""
import json, os, sys, time
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); ndev = int(sys.argv[3])
port = sys.argv[4]; out = sys.argv[5]; steps = int(sys.argv[6])
batch_per_dev = int(sys.argv[7]); backend = sys.argv[8]
sys.path.insert(0, os.environ["CDLRM_REPO"])
import jax
if backend == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", ndev)
elif jax.default_backend() != "gpu" or jax.local_device_count() != ndev:
    raise SystemExit(f"want {ndev} local GPUs, JAX found "
                     f"{jax.local_device_count()} on {jax.default_backend()}")
if nproc > 1:
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
import numpy as np
from cdlrm_tpu.config import Config
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer

world = jax.device_count()
batch = batch_per_dev * world
cfg = Config(
    arch_sparse_feature_size=16,
    arch_embedding_size="-".join(["20000"] * 8),
    arch_mlp_bot="13-64-16", arch_mlp_top="16-8-1",
    mini_batch_size=batch, world_size=world,
    cache_size=1024, num_ways=4, loss_function="bce",
    lookahead=8, table_agg_freq=100, print_freq=10**9,
    round_targets=True, numpy_rand_seed=3,
    num_indices_per_lookup=1, num_indices_per_lookup_fixed=True,
    master_init="virtual",
)
cfg.finalize()
warm = max(4, steps // 5)
ds = SyntheticDataset(
    m_den=13, ln_emb=cfg.ln_emb, data_size=batch * (warm + steps + 4),
    mini_batch_size=batch, num_indices_per_lookup=1,
    num_indices_per_lookup_fixed=True, round_targets=True, seed=7,
)
tr = CachedDlrmTrainer(cfg, ds)
tr.train(max_steps=warm, log_fn=lambda s: None)
t0 = time.perf_counter()
m = tr.train(max_steps=warm + steps, log_fn=lambda s: None)
dt = time.perf_counter() - t0
tr.close()
if pid == 0:
    with open(out, "w") as f:
        json.dump({"world": world, "examples_per_sec": steps * batch / dt,
                   "ms_per_iter": 1000 * dt / steps}, f)
"""


def card_env(backend, proc, ndev):
    """Per-process environment: on GPUs, process ``proc`` sees only cards
    [proc*ndev, (proc+1)*ndev)."""
    if backend != "gpu":
        return {}
    cards = range(proc * ndev, (proc + 1) * ndev)
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(c) for c in cards)}


def run_topology(nproc, ndev, steps, batch_per_dev, backend, port):
    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "worker.py")
        with open(worker, "w") as f:
            f.write(_WORKER)
        out = os.path.join(td, "out.json")
        # stderr goes to FILES: a crashed worker writing >64KB to an
        # un-drained pipe would block forever while its peer waits in a
        # collective
        errs = [open(os.path.join(td, f"err{p}.log"), "wb") for p in range(nproc)]
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(p), str(nproc), str(ndev),
                 str(port), out, str(steps), str(batch_per_dev), backend],
                env={**os.environ,
                     "CDLRM_REPO": os.path.dirname(os.path.abspath(__file__)),
                     **card_env(backend, p, ndev)},
                stdout=subprocess.DEVNULL, stderr=errs[p],
            )
            for p in range(nproc)
        ]
        try:
            for p, proc in enumerate(procs):
                proc.communicate(timeout=1800)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            for f in errs:
                f.close()
        for p, proc in enumerate(procs):
            if proc.returncode != 0:
                with open(os.path.join(td, f"err{p}.log")) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(f"worker {p} failed:\n{tail}")
        with open(out) as f:
            return json.load(f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch-per-device", type=int, default=128)
    ap.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--port", type=int, default=12513)
    args = ap.parse_args()

    single = run_topology(1, args.hosts * args.devices_per_host, args.steps,
                          args.batch_per_device, args.backend, args.port)
    print(json.dumps({"topology": "1-process", **single}))
    multi = run_topology(args.hosts, args.devices_per_host, args.steps,
                         args.batch_per_device, args.backend, args.port + 1)
    print(json.dumps({"topology": f"{args.hosts}-process", **multi}))
    eff = multi["examples_per_sec"] / max(1e-9, single["examples_per_sec"])
    print(json.dumps({
        "metric": "multihost_scaling_efficiency",
        "value": round(eff, 3),
        "unit": f"x (same global mesh, 1 vs {args.hosts} processes)",
        "note": ("CPU backend on one machine: processes contend for the same "
                 "cores — lower bound only" if args.backend == "cpu" else
                 "GPU measurement"),
    }))


if __name__ == "__main__":
    main()
