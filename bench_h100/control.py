"""The readings the limits of ``correct`` are set from, on many seeds, in one
process: for each seed one span of the cell at its own size, the numbers the
check compares for the program, and for the control seeds the same numbers
for the control (the reference computed in float32 in the program's place,
held to the reference in float64).  The benchmark's own runs do not run it.

    python bench_h100/control.py --workload sac1024.flight \\
        --seeds 2147483649,2147483650 --control-seeds 2147483649 --out FILE

One JSON line a seed, on standard output and appended to ``--out``."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".bench_cache", "nv"))


def readings(manifest: dict, workload: str, seeds, control_seeds, device: str,
             root: Path, bench: Path, out=None):
    import torch

    from bench_h100 import check as CH
    from bench_h100 import harness as H
    from gple_tpu_torch.ops import _build

    cell = H.Cell(manifest, workload, root, bench)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.library()
    outroot = Path(tempfile.mkdtemp(prefix="bench_h100_ctl_", dir=tempfile.gettempdir()))
    rows = []
    try:
        H.warm_up(cell, device, outroot)
        for i, seed in enumerate(seeds):
            cfg = cell.gple_config(seed)
            t0 = time.perf_counter()
            span = H.run_span(cell, cfg, device, float("inf"), outroot, i)
            row = dict(workload=workload, seed=seed, span_s=time.perf_counter() - t0,
                       events=sorted(span["events"]), stats=span["stats"])
            prog = CH.evaluate(cfg, span["snaps"], span["events"], seed, device,
                               outdir=span["outdir"])
            row.update(program=prog.values, notes=prog.notes)
            if seed in control_seeds:
                ctl = CH.evaluate(cfg, span["snaps"], span["events"], seed, device,
                                  outdir=span["outdir"], control_dtype=torch.float32)
                row.update(control=ctl.values, control_notes=ctl.notes)
            if span["outdir"]:
                shutil.rmtree(span["outdir"], ignore_errors=True)
            del span
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(outroot, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from bench_h100 import harness as H

    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    readings(manifest, args.workload, seeds, control, args.device, H.ROOT, H.BENCH, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
