"""The port's benchmark on the H100: one run of one cell.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell of ``BENCHMARK.json`` on the card this process sees and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``:
each number the check compared with its limit, which also end standard
error.  It exits non-zero, printing no result, without a CUDA device, when a
forbidden module (JAX, the JAX package) is loaded, or when the program is
missing."""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the CUDA driver's kernel cache, at a fixed path inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".bench_cache", "nv"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_h100 import harness as H

    t_start = H.process_start()
    import torch

    manifest = H.read_json(H.ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"bench_h100: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"bench_h100: {entry['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        result = H.run_cell(manifest, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_start,
                            log=lambda line: print(line, file=sys.stderr, flush=True))
    except Exception:
        traceback.print_exc()
        return 1
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
