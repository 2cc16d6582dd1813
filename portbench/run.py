"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the cell's ``config``
names, its traffic in ``portbench/traffic/<cell>.json`` (parameters, the
driver that generates and sends it, the limits of its comparison), its
per-layer metrics in ``portbench/metrics/<metric>.py`` (a ``read(state)``
that returns the value, or None where it finds nothing to read).

A run makes its inputs and weights from ``--seed``, warms up, measures
for ``--seconds`` (``--trace 1``: then traces a short segment for the
per-layer metrics), judges what the window produced against the plain
references in ``portbench/reference/``, and prints one JSON object as the
last line of standard output.  The numbers compared, each with its limit,
end standard error.  It exits 2 without a result when CUDA or enough
cards are missing, and 3 when JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "sdag_tpu")


def load_json(path: str) -> Any:
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden
    (``sdag_tpu_torch`` is not ``sdag_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell(bench: Dict[str, Any], name: str):
    """(workload entry, configuration, traffic) of a cell."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return (wl, load_json(centry["file"]),
            load_json(f"portbench/traffic/{name}.json"))


def _applies(metric: Dict[str, Any], name: str, e2e: List[str]) -> bool:
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e


def reader(metric: str):
    path = os.path.join(ROOT, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float,
             trace: bool, device, cfg: Optional[Dict] = None,
             tr: Optional[Dict] = None, control: str = "",
             ref_control: bool = False,
             t_start: Optional[float] = None) -> Dict[str, Any]:
    """Set up, measure, judge; returns the result object (the checks
    last).  ``cfg``/``tr`` replace the cell's files (the tests' small
    sizes); ``control`` switches on the program's lower-precision path
    (the traffic's ``control``), ``ref_control`` adds the readings of the
    reference computed in the lower precision (``control_*`` checks)."""
    import torch
    wl, cfg0, tr0 = cell(bench, name)
    cfg, tr = cfg or cfg0, tr or tr0
    drv = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    cuda = device.type == "cuda"
    t0 = time.perf_counter() if t_start is None else t_start
    st = drv.setup(cfg, tr, seed, device, control=control)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    res = drv.window(st, seconds)
    metrics: Dict[str, Dict[str, Any]] = {}
    produced = dict(res["metrics"], setup_s=(setup_s, "s"))
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": int(wl["chips"])}
    out: Dict[str, Any] = {}
    if trace:
        drv.trace_segment(st)
        drv.layer_inputs(st)
        seg = st["segment"]
        dev_info["busy_s"] = seg.busy_s
        dev_info["window_s"] = seg.window_s
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for m in bench["per_layer"]:
            if _applies(m, name, e2e):
                v = reader(m["name"])(st)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": units[m["name"]]}
        out["breakdown"] = seg.breakdown()
    else:
        for m in e2e:
            if m not in produced:
                raise RuntimeError(f"the driver produced no {m!r}")
            metrics[m] = {"value": float(produced[m][0]),
                          "unit": produced[m][1]}
    dev_info["memory_peak_bytes"] = int(
        torch.cuda.max_memory_allocated(device)) if cuda else 0
    drv.release(st)
    checks = drv.check(st, control=ref_control)
    correct = all(v <= lim for n, v, lim in checks
                  if not n.startswith("control_"))
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": dev_info}
    result.update(out)
    result["notes"] = st.get("notes", {})
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def _power_limit() -> Optional[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    wl, _, _ = cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    pl = _power_limit()
    if pl:
        print(f"card: {result['device']['kind']}, power limit {pl}",
              file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
