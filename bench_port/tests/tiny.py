"""A throwaway cell for the CPU tests, added to a copy of the benchmark's
files: the dpvo configuration at 96x128 with 16 patches a frame and f32
networks, one stream of 40-frame walks, the dpvo cell's limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny.walk"


def make_root(tmp: Path, extra_metric: str = None) -> Path:
    """A checkout of BENCHMARK.json and bench_port/ under tmp (the weights
    linked), with the tiny cell added by files and entries alone; with
    ``extra_metric``, also a per-layer metric of that name whose reader
    counts the tracked frames."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "weights").symlink_to(ROOT / "weights")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench_port/configs/dpvo.json").read_text())
    cfg.update(ht=96, wd=128)
    cfg["config"].update(PATCHES_PER_FRAME=16, BUFFER_SIZE=512, E_MAX=8192, M_OPT_MAX=512,
                         E_INAC_MAX=8192, MIXED_PRECISION=False)
    (root / "bench_port/configs/tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "bench_port/traffic/eval1_walk.json").read_text())
    traffic.update(frames=40, sequences=2, warm_frames=10,
                   checks=[{"kind": "init"}, {"kind": "frame", "from": 14}])
    traffic["trajectory"]["pool"] = [4, 8]
    (root / "bench_port/traffic/tiny_walk.json").write_text(json.dumps(traffic))
    bench["configs"].append(dict(name="tiny", source="https://github.com/princeton-vl/DPVO",
                                 file="bench_port/configs/tiny.json", reduced=[], why="tests"))
    bench["workloads"].append(dict(name=CELL, config="tiny", traffic="tiny_walk", chips=1,
                                   why="tests"))
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    if extra_metric:
        (root / f"bench_port/metrics/{extra_metric}.py").write_text(
            "def read(ctx):\n    return float(ctx['frames']) if ctx['frames'] else None\n")
        bench["per_layer"].append(dict(name=extra_metric, unit="frames", better="higher",
                                       source="host_clock", layer="tests",
                                       moves="frames_per_s", workloads=[CELL]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, seconds: float = 14.0, trace: bool = False, tracker=None, seed: int = 5):
    from bench_port.run import run_cell

    lines = []
    result = run_cell(CELL, seed, seconds, trace, device="cpu", root=root, log=lines.append,
                      tracker=tracker)
    return result, lines
