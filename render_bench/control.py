#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell, on the card.

    python3 render_bench/control.py --workload <cell> --seconds <s> --plant <plant> --seeds 1 2 3 ...

For each seed, in one process, one run of the cell as run.py makes it (set-up,
a window of ``--seconds``, the check), with the plant of render_bench/plant.py
under the timed path (``none``: the program as it is, the lower reading; the
control or a fault: the upper). One JSON line a seed: ``correct``, the frames
attempted and the numbers compared with their limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from render_bench.plant import PLANTS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plant", choices=["none", *PLANTS], default="none")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from render_bench import cell, plant
    from render_bench.run import Run, run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = cell.benchmark()
    w = cell.workload(bench, args.workload)
    metrics = cell.metrics_for(bench, args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        run = Run(cell.config(w["config"]), cell.traffic(w["traffic"]), seed,
                  torch.device("cuda", 0), t0=t)
        with plant.planted(None if args.plant == "none" else args.plant):
            out = run_cell(run, args.seconds, False, metrics)
        print(json.dumps({"workload": args.workload, "plant": args.plant, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"], "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
