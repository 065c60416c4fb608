#!/usr/bin/env python3
"""The float64 partition check of the dry run's sharded steps at full width,
on a host's CPU: four gloo ranks over a 2 x 2 ``("data", "model")`` mesh.

    python3 scripts/torch_sharded_f64.py          # train-mamba2, prefill-mamba2, decode-olmoe
    python3 scripts/torch_sharded_f64.py --cases decode-olmoe --layers decode-olmoe=2
    python3 scripts/torch_sharded_f64.py --smoke   # every case at smoke width, a few seconds

For each case of ``launch/sharded_step.py``'s ``CASES`` named, rank 0 first
runs the step unsharded in float64 over the data ranks' row groups
(``sharded_step.reference`` with ``dtype=torch.float64``: the case's weights
drawn as its own step draws them, then widened; caches and moments float64)
on every core of the host, keeps only its results and frees the rest, while
the other ranks wait; then the four ranks run the same step sharded in
float64 (``case_step(mesh, dtype=torch.float64)``), the host's cores over
four threads a rank, and rank 0 holds it against the unsharded one at
``sharded_step.F64_TOL`` = 1e-9 (``compare_f64``: a train step's loss,
gradient norm, every parameter and both moments; a prefill's or decode
step's logits on every row, every cache leaf and written row, greedy
tokens equal on every row). Both steps run under ``NarrowOps``, which
names every op that gives a floating output narrower than float64.

The cases' depth is cut only where ``--layers`` (or ``DEPTH``) says: OLMoE
to 4 of its 16 layers by default (whole, it is about 55 GB a float64 copy).
Widths are whole. Needs no card; float64 reaches no kernel (the wrappers
take float64 on the CPU only, in their plain versions).

Rank 0 prints one JSON line a case (the worst leaf and its error, each
part's worst, a train step's parameter error over the elements whose
first moment is above 1e-8, 1e-6 and 1e-4 of its leaf's largest, the
logits error and greedy equality by row, the ops narrower than float64,
the host seconds of both steps, each rank's peak RSS; with ``--floor``
also the unsharded step over the whole batch in one group against the
grouped one, printed, never a limit), then ``{"ok": ...}``. The card's name and power limit are printed
first where ``nvidia-smi`` answers: they name the machine whose CPU ran it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

WORLD, N_DATA, N_MODEL = 4, 2, 2
DEFAULT_CASES = ("train-mamba2", "prefill-mamba2", "decode-olmoe")
#: the depth cuts of the full-width run: OLMoE's 16 layers to 4, as
#: train-olmoe is cut (float64 doubles float32's 28 GB a copy)
DEPTH = {"decode-olmoe": 4}
SEED = 0


def peak_rss_gib() -> float:
    """This process's peak resident set so far, in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def case_cfg(ss, name, smoke, layers):
    cfg = ss.case_config(name, smoke)
    n = layers.get(name)
    return dataclasses.replace(cfg, num_layers=n) if n else cfg


def run(rank, init, out_path, cases, smoke, layers, threads, ref_threads,
        floor):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharded_step as ss
    from repro_torch.launch.mesh import make_debug_mesh

    # The other ranks wait at a barrier while rank 0 runs the unsharded
    # step, minutes at full width.
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(hours=3))
    mesh = make_debug_mesh(N_DATA, N_MODEL)
    for name in cases:
        cfg = case_cfg(ss, name, smoke, layers)
        want, row = None, None
        if rank == 0:
            torch.set_num_threads(ref_threads)
            rss0 = peak_rss_gib()
            t0 = time.perf_counter()
            _, shape, step, args = ss.case_step(
                name, None, "cpu", smoke=smoke, seed=SEED, cfg=cfg,
                n_micro=N_DATA, dtype=torch.float64)
            with ss.NarrowOps() as ref_audit:
                out = step(*args)
            want = ss.step_results(shape.kind, out, to=None)
            del out, step, args
            gc.collect()
            row = {"case": name, "layers": cfg.num_layers,
                   "B": shape.global_batch, "S": shape.seq_len,
                   "reference_s": time.perf_counter() - t0,
                   "reference_threads": ref_threads,
                   "rss_peak_gib_before_reference": rss0,
                   "rss_peak_gib_after_reference": peak_rss_gib()}
            if floor:
                # the same function over the whole batch in one group, no
                # partition: how far reordered float64 sums alone move it
                t0 = time.perf_counter()
                other = ss.reference(name, "cpu", smoke=smoke, seed=SEED,
                                     cfg=cfg, dtype=torch.float64)
                cmp = ss.compare_f64(shape.kind, other, want)
                row["floor"] = {k: cmp[k] for k in (
                    "errs", "worst", "worst_err", "worst_mu_at",
                    "param_err_where_mu_above", "over") if k in cmp}
                row["floor"]["seconds"] = time.perf_counter() - t0
                del other
                gc.collect()
        dist.barrier()
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        _, shape, step, args = ss.case_step(name, mesh, "cpu", smoke=smoke,
                                            seed=SEED, cfg=cfg,
                                            dtype=torch.float64)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ss.NarrowOps() as audit:
            out, _ = ss.run_counted(step, args)
        step_s = time.perf_counter() - t0
        got = ss.step_results(shape.kind, out, keep=rank == 0)
        del out, step, args
        gc.collect()
        ops = [None] * WORLD
        dist.all_gather_object(ops, (audit.ops, peak_rss_gib()))
        if rank == 0:
            row.update(ss.compare_f64(shape.kind, got, want))
            narrow = dict(ref_audit.ops)
            for rec, _ in ops:
                for k, n in rec.items():
                    narrow[k] = narrow.get(k, 0) + n
            row.update(sharded_build_s=build_s, sharded_step_s=step_s,
                       threads_per_rank=threads, narrow_ops=narrow,
                       rss_peak_gib_per_rank=[r for _, r in ops])
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            del got, want
            gc.collect()
        dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(DEFAULT_CASES))
    ap.add_argument("--smoke", action="store_true",
                    help="every case at smoke width (default: all cases)")
    ap.add_argument("--layers", action="append", default=[],
                    help="case=N: cut the case to N layers")
    ap.add_argument("--floor", action="store_true",
                    help="also hold the unsharded step over the whole batch "
                    "against it (printed, never a limit)")
    args = ap.parse_args(argv)
    from repro_torch.launch.sharded_step import CASES

    cases = list(CASES) if args.smoke and args.cases == ",".join(
        DEFAULT_CASES) else args.cases.split(",")
    unknown = [c for c in cases if c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    layers = {} if args.smoke else dict(DEPTH)
    for item in args.layers:
        name, n = item.split("=")
        layers[name] = int(n)
    cores = len(os.sched_getaffinity(0))
    threads = max(1, cores // WORLD)

    import torch.multiprocessing as mp

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    print(smi or "nvidia-smi: no card named", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="torch_sharded_f64_"))
    out = tmp / "out"
    failed = []
    t0 = time.perf_counter()
    try:
        # forked before this process runs any op: each rank starts clean
        mp.start_processes(run, args=(f"file://{tmp / 'rendezvous'}",
                                      str(out), cases, args.smoke, layers,
                                      threads, cores, args.floor),
                           nprocs=WORLD, start_method="fork")
    except Exception as e:  # noqa: BLE001 -- print the rows before it
        failed.append(f"ranks: {str(e)[-3000:]}")
    rows = [json.loads(line) for line in
            (out.read_text().splitlines() if out.exists() else [])]
    for row in rows:
        print(json.dumps(row), flush=True)
        if not row["ok"]:
            failed.append(row["case"])
    missing = [c for c in cases if c not in {r["case"] for r in rows}]
    if failed or missing:
        print(f"torch_sharded_f64: failed {failed}, missing {missing}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "cases": cases, "cores": cores,
                      "threads_per_rank": threads, "layers": layers,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
