"""Throwaway cells for the CPU tests, added to a copy of the benchmark's
files: ``tiny.walk``, the dpvo configuration at 96x128 with 16 patches a
frame and f32 networks, one stream of 40-frame walks, the dpvo cell's
limits; ``tiny.train``, the training recipe on 4-frame 64x64 clips with 4
patches a frame, 4 unroll steps and small f32 networks from the seed."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the tiny training cell's limits, from its readings on the CPU (seeds 1-8
# of the program, f32 on both sides: grad_gap <= 0.025, fnet_grad <= 0.134,
# param_gap <= 0.024; the control on seeds 1-5: grad_gap >= 0.107,
# fnet_grad >= 0.644; the faults on seeds 5-6: zero_update_grads, no_clip
# and unchanged 1.0 or more, corr_bwd_scale fnet_grad >= 0.521,
# corr_bwd_shift fnet_grad >= 0.718). Its gradients' global norm is
# 0.37-1.2, so its clip is set where it acts
TRAIN_LIMITS = {"grad_gap": 0.06, "fnet_grad": 0.3, "param_gap": 0.1}
TRAIN_CLIP = 0.25
CELL = "tiny.walk"
TRAIN = "tiny.train"


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
    train = json.loads((ROOT / "bench_port/configs/vonet_train.json").read_text())
    train.update(ht=64, wd=64, weights=None, limits=TRAIN_LIMITS)
    train["config"].update(PATCHES_PER_FRAME=4, DIM=32, FDIM=16, MIXED_PRECISION=False)
    train["recipe"].update(n_frames=4, unroll=4, clip=TRAIN_CLIP)
    (root / "bench_port/configs/tiny_train.json").write_text(json.dumps(train))
    clips = json.loads((ROOT / "bench_port/traffic/train_b1.json").read_text())
    clips.update(clips=4, planes=3)
    (root / "bench_port/traffic/tiny_clips.json").write_text(json.dumps(clips))
    bench["configs"].append(dict(name="tiny_train", source="https://github.com/princeton-vl/DPVO",
                                 file="bench_port/configs/tiny_train.json", reduced=[],
                                 why="tests"))
    bench["workloads"].append(dict(name=TRAIN, config="tiny_train", traffic="tiny_clips",
                                   chips=1, why="tests"))
    for m in bench["per_layer"]:
        if "vonet_train.b1" in m["workloads"]:
            m["workloads"].append(TRAIN)
    for m in bench["end_to_end"]:   # a metric of some cells: the stream's, training's
        cells = m.get("workloads")
        if cells is not None:
            cells += [CELL] * ("dpv_slam.eval1" in cells) + [TRAIN] * ("vonet_train.b1" in cells)
    if extra_metric:
        (root / f"bench_port/metrics/{extra_metric}.py").write_text(
            "def read(ctx):\n    return float(ctx['frames']) if ctx['frames'] else None\n")
        bench["per_layer"].append(dict(name=extra_metric, unit="frames", better="higher",
                                       source="host_clock", layer="tests",
                                       moves="frames_per_s", workloads=[CELL]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, seconds: float = 14.0, trace: bool = False, seed: int = 5, cell: str = CELL,
        **hooks):
    from bench_port.run import run_cell

    lines = []
    result = run_cell(cell, seed, seconds, trace, device="cpu", root=root, log=lines.append,
                      **hooks)
    return result, lines
