"""Readings that a cell's limits are set from, several seeds in one
process on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 8 --mode sound|control

``sound``: the program as the cell runs it.  ``control``: the program's
lower-precision path named by the traffic's ``control`` (``int8``: int8
weights and KV cache), plus the readings of the reference computed in the
lower precision (``control_*``).  One JSON line per seed with every number compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--mode", choices=("sound", "control"), required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json("BENCHMARK.json")
    _, _, tr = run.cell(bench, args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctl = args.mode == "control"
        res = run.run_cell(bench, args.workload, seed, args.seconds, False,
                           dev, control=tr["control"] if ctl else "",
                           ref_control=ctl)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "metrics": res["metrics"],
                          "notes": res["notes"],
                          "checks": res["checks"]}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
