"""One run of one cell of ``BENCHMARK.json`` on one card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration (``configs/<config>.json``) names the runner that
runs it: ``"runner": "<name>"`` loads ``runners/<name>.py`` by its file, as
the traffic generators (``traffic/``) and the metric readers
(``metrics/``) are loaded; without the key the runner is ``stream``, the
camera stream of the tracker's cells. A later cell brings a runner of its
own as a new file, with no edit here.

A runner is a module with a function ``run(cell, config, traffic, seed,
seconds, trace, device, root, log, started, **hooks)``. It gets the cell's
entry of ``BENCHMARK.json``, its configuration and traffic files as
dicts, the seed, the window's seconds, whether the run is traced, the
``torch.device`` (a card, or the CPU in the tests), the checkout whose
``bench_port/`` data it reads, a ``log`` for standard error, the
process's start on ``time.perf_counter()`` (set-up is measured from it)
and the tests' hooks (a control or a fault in the program's place). It
builds and warms the program, measures ``seconds`` of the wall clock,
reads the peak memory, frees the program and has the plain reference
decide ``correct``. It returns a dict:

  ctx        what the readers read (``metrics/<name>.py``): at least
             ``setup_s`` and ``peak_bytes`` (the window's peak of allocated
             device memory, the result's ``memory_peak_bytes``), and what
             each of the cell's metrics reads
  attempted, failed
             the units of work the window attempted and those that failed
  correct    the verdict of the reference's comparison
  checks     each number compared: {name: {"value", "limit"}}
  profile    with ``trace``: ``profile_window.summarize`` of the traced
             seconds (``busy_s``, ``window_s``, the breakdown), else None
  breakdown  further lists for the result's breakdown, or {}

A runner also has ``calibrate(config, traffic, seeds, control_seeds,
fault_seeds, device, root, emit)``, which ``calibrate.py`` calls: the
readings that the limits of ``correct`` are set from, one dict a reading
to ``emit``, returning each side's extreme of every number.

This module prints the result, its last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py`` from ``ctx`` (a
reader that finds nothing returns None, and the metric is left out).
With ``--trace 1`` the stream runner turns the port's recorder on over
the window, and its spans and counters reach the readers as
``ctx["program_spans"]`` and ``ctx["program_counts"]``. Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded at the end, the run exits nonzero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_port":
    sys.path[0] = str(ROOT)  # the harness's modules by their package names only
from bench_port.harness import FORBIDDEN, NoCard  # noqa: E402


def load_cell(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration file, traffic file) of cell ``name``."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def load_module(root: Path, sub: str, name: str):
    """Module ``bench_port/<sub>/<name>.py`` under root, by its file."""
    path = root / "bench_port" / sub / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.{sub}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metric entries the cell reports in this mode."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(root: Path, name: str, ctx: dict):
    return load_module(root, "metrics", name).read(ctx)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = ROOT, log=print, **hooks) -> dict:
    """Run the cell and return the result's object. ``device`` None takes
    the card (``NoCard`` without one); tests pass ``"cpu"``. ``root``: the
    checkout whose ``BENCHMARK.json`` and ``bench_port/`` data, runners and
    readers are read (the harness's own modules and the port are this
    one's). ``hooks`` go to the runner (the tests' control and faults)."""
    import torch

    from bench_port import harness, profile_window

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, config, traffic = load_cell(bench, workload, root)
    device = harness.card(cell, device)
    torch.set_num_threads(1)
    name = config.get("runner", "stream")
    if not (root / "bench_port" / "runners" / f"{name}.py").is_file():
        raise KeyError(f"no runner {name!r} (bench_port/runners/{name}.py) for {workload}")
    runner = load_module(root, "runners", name)
    out = runner.run(cell, config, traffic, seed, seconds, trace, device, root, log, T_START,
                     **hooks)

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = read_metric(root, m["name"], out["ctx"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["ctx"]["peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    summary = out.get("profile")
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {**profile_window.breakdown(summary), **out.get("breakdown", {})}
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "runs" / "cache" / "cuda"))
    err = lambda s: print(s, file=sys.stderr, flush=True)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), log=err)
    except NoCard as e:
        err(f"no result: {e}")
        return 3
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        err(f"no result: the process loaded {loaded}")
        return 4
    for k, v in result["checks"].items():
        err(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
