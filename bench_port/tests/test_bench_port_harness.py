"""The harness on the CPU: every cell, configuration, traffic and metric
found by name; a cell, a traffic and a metric added by files alone; the
arithmetic on fixed inputs; the import closures; no card, no result."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from bench_port.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    from bench_port.run import load_cell, load_module

    w, config, traffic = load_cell(BENCH, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    gen = load_module(ROOT, "traffic", traffic["kind"])
    runner = load_module(ROOT, "runners", config.get("runner", "stream"))
    assert callable(runner.run)
    if "runner" in config:   # the training cells
        assert callable(gen.make_clips) and config["runner"] == "train"
        assert set(config["limits"]) == set(runner.NUMBERS)
    else:
        assert callable(gen.make_sequences)
        assert set(config["limits"]) >= {"feat_gap", "pose_gap", "structure"}
    assert (ROOT / config["weights"]).exists()


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    from bench_port.run import load_module

    assert callable(load_module(ROOT, "metrics", metric).read)


def test_names_units_and_bounds():
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = {e["name"]: set(e.get("workloads", cells)) for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= reports[m["moves"]] <= cells
    for cell in cells:   # setup_s, another end-to-end metric and a per-layer one
        assert sum(cell in r for r in reports.values()) >= 2 and reports["setup_s"] == cells
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers["kernels: csrc/*.cu"]) == 3
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_percentile_and_spread():
    from bench_port.stats import percentile, spread

    vals = list(range(1, 101))
    assert percentile(vals, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, 3, 4], 50) == 2.5
    # statistics.quantiles(range(1, 9), n=4) = [2.25, 4.5, 6.75]
    assert spread(range(1, 9)) == pytest.approx((6.75 - 2.25) / 4.5)


def test_roofline_arithmetic():
    from bench_port.roofline import (PEAK_BF16, PEAK_F32, bound, corr_cost, segsum_cost,
                                     update_flops)

    assert bound(3.35e9, 1.0, PEAK_F32) == (pytest.approx(1.0), "bytes")
    assert bound(1.0, 989e9, PEAK_BF16) == (pytest.approx(1.0), "operations")
    nbytes, flops = corr_cost(10, 2, 3, 120, 160, 128)
    assert flops == 10 * 2 * 9 * 64 * 128 * 2
    assert nbytes == (2 * (120 * 160 + 30 * 40) * 128 * 2 + 3 * 128 * 9 * 2 + 10 * 9 * 2 * 4
                      + 10 * 9 + 10 * 9 * 128 * 2)
    assert segsum_cost(100, 98, 50, 4) == (100 * 8 + 50 * 98 * 4 + 100 * 98 * 4, 100 * 98)
    assert update_flops(1, 0, 384, 1152) == 2 * (1152 * 384 + 16 * 384 * 384 + 4 * 384)


def test_model_flops_match_the_layers():
    """The counted FLOP of both encoders and of the update operator's
    per-edge products equal the reference network's layers, summed from
    their shapes in a forward pass."""
    import torch

    from bench_port.reference.config import Config
    from bench_port.reference.runtime.weights import load_networks
    from bench_port.roofline import patchify_flops, update_flops

    cfg = Config()
    nets = load_networks(cfg)
    macs = []

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()
            macs.append(out.shape[1] * out.shape[2] * out.shape[3] * k)
        else:
            macs.append(out.shape[0] * mod.in_features * mod.out_features)

    handles = [m.register_forward_hook(hook) for m in nets.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        img = torch.zeros(1, 32, 48, 3)
        nets.patchifier.fnet(img)
        nets.patchifier.inet(img)
        assert 2 * sum(macs) == patchify_flops(32, 48, cfg.FDIM, cfg.DIM)
        macs.clear()
        E, D = 6, cfg.DIM
        seg = torch.tensor([0, 0, 1, 1, 2, 2])
        nets.update(torch.zeros(E, D), torch.zeros(E, D), torch.zeros(E, cfg.CORR_WIDTH),
                    torch.arange(E), torch.arange(E), torch.zeros(E, dtype=torch.bool),
                    torch.zeros(E, dtype=torch.bool), seg, seg,
                    torch.ones(E, dtype=torch.bool), num_segments=3)
    for h in handles:
        h.remove()
    # the SoftAggs' output layers run per group: 3 groups each here
    assert 2 * sum(macs) == update_flops(E, 3, D, cfg.CORR_WIDTH) + 2 * 3 * D * D


def test_readers_on_a_fixed_run():
    from bench_port.run import read_metric

    prof = dict(ops=[("corr_tile_kernel(x)", 0.0, 1000.0), ("segsum_kernel<float>", 1000.0,
                                                               1100.0),
                     ("Memcpy HtoD", 3000.0, 3100.0)],
                kernels=2, busy_s=1.2e-3, window_s=3.1e-3, gaps=[])
    ctx = dict(frames=10, window_s=2.0, latencies_ms=[float(i) for i in range(1, 11)],
               setup_s=7.0, peak_bytes=2 ** 31, spans_ms={"patchify": [1.0] * 10,
                                                          "edge_forward": [], "window_ba": [],
                                                          "global_ba": []},
               gba_round_ms=[], profile=prof, profile_frames=1,
               corr_calls=[(1000, 10, 1000, 120, 160, 128)], segsum_calls=[(1000, 98, 500, 4)],
               edge_rounds=[], patchifies=0, config={}, ht=480, wd=640)
    get = lambda n: read_metric(ROOT, n, ctx)
    assert get("frames_per_s") == 5.0
    assert get("traced_frames_per_s") == 5.0
    assert get("traced_frame_ms_p95") == pytest.approx(9.55)
    assert get("peak_mem_gib") == 2.0
    assert get("patchify_ms") == 1.0 and get("edge_forward_ms") is None
    assert get("launches_per_frame") == 2.0
    assert get("device_idle_pct") == pytest.approx(100 * (1 - 1.2 / 3.1))
    from bench_port.roofline import PEAK_BF16, PEAK_F32, bound, corr_cost, segsum_cost

    assert get("corr_roofline") == pytest.approx(
        100 * bound(*corr_cost(1000, 10, 1000, 120, 160, 128), PEAK_BF16)[0] / 1.0)
    assert get("segsum_roofline") == pytest.approx(
        100 * bound(*segsum_cost(1000, 98, 500, 4), PEAK_F32)[0] / 0.1)
    assert get("mfu_pct") is None and get("gba_round_ms") is None
    assert get("corr_bwd_roofline") is None   # no training step profiled


def test_the_training_readers_on_a_fixed_step():
    """corr_bwd_roofline, corr_roofline, segsum_roofline, launches_per_frame,
    mfu_pct and frames_per_s on a synthetic profile of one training step,
    its correlation calls as the ``corr`` probe records them."""
    import torch

    from bench_port.harness import corr_shapes
    from bench_port.roofline import (PEAK_BF16, PEAK_F32, bound, corr_bwd_cost, corr_cost,
                                     corr_flops, patchify_flops, segsum_cost, update_flops)
    from bench_port.run import read_metric

    prof = dict(ops=[("void corr_bwd_f1_kernel<bf16>", 0.0, 1500.0),
                     ("void corr_bwd_map_kernel<bf16>", 1500.0, 2000.0),
                     ("segsum_kernel<float>", 2000.0, 2100.0),
                     ("void corr_tile_kernel<bf16>", 2100.0, 2500.0)],
                kernels=4, busy_s=2.5e-3, window_s=5.0e-3, gaps=[], trace_start_ns=0)
    call = (18000, 1200, 15, 120, 160, 30, 40, 128, 17000)
    cfg = dict(P=3, CORR_LEVELS=2, CORR_RADIUS=3, FDIM=128, DIM=384)
    # 6 edges from the patch rows 0, 1, 3 into the frames 2 and 5
    corr = corr_shapes([(6, torch.tensor([2, 5, 2, 5, 5, 2]), torch.tensor([0, 1, 3, 0, 1, 3]),
                         120, 160, 128)])
    assert corr == [(6, 2, 3, 120, 160, 128)]
    ctx = dict(frames=30, window_s=10.0, profile=prof, corr_bwd_calls=[call], corr_calls=corr,
               profile_frames=15, segsum_calls=[(18000, 92, 1200, 4)],
               edge_rounds=[(5000, 700)] * 2, patchifies=30, passes=3, config=cfg, ht=480,
               wd=640)
    get = lambda n: read_metric(ROOT, n, ctx)
    assert get("frames_per_s") == 3.0
    assert get("launches_per_frame") == pytest.approx(4 / 15)
    assert get("corr_roofline") == pytest.approx(
        100 * bound(*corr_cost(*corr[0]), PEAK_BF16)[0] / 0.4)
    assert get("corr_bwd_roofline") == pytest.approx(
        100 * bound(*corr_bwd_cost(*call), PEAK_BF16)[0] / 2.0)
    assert get("segsum_roofline") == pytest.approx(
        100 * bound(*segsum_cost(18000, 92, 1200, 4), PEAK_F32)[0] / 0.1)
    flops = (30 * patchify_flops(480, 640, 128, 384)
             + 2 * (update_flops(5000, 700, 384, 1152) + corr_flops(5000, 128)))
    assert get("mfu_pct") == pytest.approx(100 * 3 * flops / 10.0 / PEAK_BF16)
    assert get("device_idle_pct") == pytest.approx(50.0)


def test_the_correlation_backward_count_is_row_8s():
    """At chip_smoke.py's row 8 (the last unroll step's 18000 edges, 15
    frames of 80 patches, 120 x 160 maps of 128 channels) the count gives
    its 0.0612 ms bound, bytes-bound."""
    from bench_port.roofline import PEAK_BF16, bound, corr_bwd_cost

    ms, by = bound(*corr_bwd_cost(18000, 1200, 15, 120, 160, 30, 40, 128, 18000), PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(0.0612, abs=5e-5)


def test_a_configuration_without_a_runner_takes_the_stream(tmp_path):
    """No ``runner`` key: ``runners/stream.py``, found by its file in the
    checkout, gets the cell and the run's arguments, and the result has
    its keys in order; a runner that no file gives raises."""
    import json

    from bench_port.run import run_cell

    root = tiny.make_root(tmp_path)
    (root / "bench_port/runners/stream.py").write_text(
        "def run(cell, config, traffic, seed, seconds, trace, device, root, log, started):\n"
        "    log(f\"stream {cell['name']} {config.get('runner')} {seed} {seconds} {trace}\")\n"
        "    return dict(ctx=dict(frames=3, window_s=1.5, setup_s=2.0, peak_bytes=0),\n"
        "                attempted=3, failed=0, correct=True, profile=None, breakdown={},\n"
        "                checks={'structure': {'value': 0, 'limit': 0}})\n")
    lines = []
    result = run_cell(tiny.CELL, 7, 1.0, False, device="cpu", root=root, log=lines.append)
    assert lines == [f"stream {tiny.CELL} None 7 1.0 False"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["metrics"]["frames_per_s"]["value"] == 2.0
    cfg = json.loads((root / "bench_port/configs/tiny.json").read_text())
    cfg["runner"] = "no_such_runner"
    (root / "bench_port/configs/tiny.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="no_such_runner"):
        run_cell(tiny.CELL, 7, 1.0, False, device="cpu", root=root, log=lines.append)


@pytest.mark.parametrize("m, own, follow, cull, followed", [
    (15.2, 0, ([14.5], 0.1), True, 1),     # across the threshold, within the band
    (16.9, 0, ([14.5], 0.1), False, 0),    # across it, beyond the band
    (15.2, 0, ([15.9], 0.1), False, 0),    # on the same side
    (15.2, None, ([14.5], 0.1), False, 0),  # the program's own magnitude
    (14.9, 0, None, True, 0),              # not judging
])
def test_a_keyframe_decision_that_rounding_tips_follows_the_program(m, own, follow, cull,
                                                                      followed):
    from types import SimpleNamespace

    from bench_port.reference.runtime.dpvo import DPVO

    ref = SimpleNamespace(cfg=SimpleNamespace(KEYFRAME_THRESH=15.0), follow=follow,
                          kf_followed=0)
    assert DPVO._cull(ref, m, own) is cull
    assert ref.kf_followed == followed


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0]"
                          " for m in sys.modules}))"], capture_output=True, text=True,
                         cwd=str(ROOT), check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_harness_imports_no_jax():
    mods = _top_level_modules("import bench_port.run, bench_port.window, bench_port.judge, "
                              "bench_port.calibrate, bench_port.profile_window, "
                              "bench_port.runners.stream, bench_port.runners.train, "
                              "dpvo_tpu_torch.runtime.dpvo, dpvo_tpu_torch.train")
    assert not mods & {"jax", "jaxlib", "flax", "dpvo_tpu"}
    assert "dpvo_tpu_torch" in mods


def test_the_reference_imports_neither_jax_nor_the_port():
    mods = _top_level_modules("import bench_port.reference.runtime.dpvo, "
                              "bench_port.reference.precision, bench_port.reference.train.step")
    assert not mods & {"jax", "jaxlib", "flax", "dpvo_tpu", "dpvo_tpu_torch"}


def test_a_run_without_a_card_exits_nonzero_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "dpvo.eval1",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_a_cell_traffic_and_metric_added_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path, extra_metric="frames_seen")
    result, lines = tiny.run(root, seconds=8.0, trace=True)
    assert result["metrics"]["frames_seen"]["value"] > 0
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"


def test_the_calibration_takes_the_runner_that_a_run_takes(tmp_path, capsys):
    """``calibrate.py`` hands a cell to its runner's ``calibrate`` as
    ``run.py`` hands it to its ``run``: the stream (no ``runner`` key)
    gives its program's and control's readings of the judge's numbers,
    the program's within the cell's limits."""
    from bench_port import calibrate, judge

    root = tiny.make_root(tmp_path)
    assert calibrate.main(["--workload", tiny.CELL, "--device", "cpu", "--root", str(root),
                           "--seeds", "5", "--control-seeds", "5"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {r["side"] for r in rows if "side" in r} == {"program", "control"}
    summary = rows[-1]
    limits = json.loads((root / "bench_port/configs/tiny.json").read_text())["limits"]
    assert set(summary["program"]) == set(judge.NUMBERS)
    assert all(summary["program"][k] <= limits[k] for k in judge.NUMBERS)
