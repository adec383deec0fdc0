"""The port's recorder (``dpvo_tpu_torch/utils/trace.py``) on the CPU:
off by default; the tracker's spans nested, on one request a frame, under
their documented names; the same poses with it on and off; the global-BA
round's attributes; the profiler's clock; the kernel launch counts that
go through it; and the self-time arithmetic of ``bench_port/program_trace.py``.

The tracker runs chip_smoke's small configuration and tiny network at
96x128 (initialized at frame 9); loop closure runs chip_smoke's loop
configuration with its scene oracle.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from bench_port import program_trace
from dpvo_tpu_torch import kernels
from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.runtime.dpvo import DPVO
from dpvo_tpu_torch.utils import trace
from dpvo_tpu_torch.utils.synthetic import PlaneScene
from test_torch_package import one_torch_thread  # noqa: F401 (autouse fixture)

HT, WD = 96, 128
FRAMES = 14
FIXTURE = "tests/fixtures/tiny_synth.npz"
FRAME_CHILDREN = {"keyframe.decide", "patchify", "ingest", "motion_probe", "topology",
                  "edge_forward", "window_ba", "keyframe"}


def _syncs():
    return {k: v for k, v in trace.COUNTS.items() if k.startswith("sync.")}


def _track(on: bool):
    """The small tracker over FRAMES frames and its terminate; the spans
    (recorder on), the poses and each call's sync.* counts."""
    scene = PlaneScene(ht=HT, wd=WD, n_frames=FRAMES, depth=5.0, seed=9002, tstep=0.3,
                       rstep=0.008)
    slam = DPVO(Config(**chip_smoke.SMALL_CFG), FIXTURE, HT, WD, device="cpu", seed=0)
    trace.drain()
    if on:
        trace.enable()
    per_call = []
    try:
        for t in range(FRAMES):
            before = _syncs()
            slam(t, scene.render(t), scene.intrinsics.copy())
            per_call.append(sum(_syncs().values()) - sum(before.values()))
        poses, _ = slam.terminate()
    finally:
        spans, _ = trace.drain()
        trace.disable()
    return dict(slam=slam, spans=spans, poses=poses, syncs=per_call)


@pytest.fixture(scope="module")
def runs():
    return {on: _track(on) for on in (True, False)}


@pytest.fixture(scope="module")
def loop_run():
    cfg = Config(**chip_smoke.LC_SMALL_CFG)
    scene = PlaneScene(ht=HT, wd=WD, n_frames=48, depth=4.0, seed=5,
                       poses=chip_smoke.loop_trajectory(48))
    slam = DPVO(cfg, None, HT, WD, device="cpu", seed=1)
    slam.oracle = chip_smoke.scene_oracle(scene, 0.25, seed=78)
    slam._motion_probe = lambda: 1e9
    trace.drain()
    trace.enable()
    try:
        for t in range(48):
            slam(t, scene.render(t), scene.intrinsics.copy())
        slam.terminate()
    finally:
        spans, _ = trace.drain()
        trace.disable()
    return dict(slam=slam, spans=spans)


def test_off_by_default_records_nothing(monkeypatch):
    assert not trace._on
    a, b = trace.span("a", E=1), trace.span("b")
    assert a is b  # the shared no-op context
    monkeypatch.setattr(time, "time_ns", lambda: pytest.fail("the clock was read"))
    with trace.span("a") as s:
        s.set(E=2)
        with trace.blocked("wait", "test", torch.device("cpu")):
            pass
    monkeypatch.undo()
    assert trace.drain()[0] == []


def test_frame_and_terminate_spans_nest_and_share_their_request(runs):
    spans = runs[True]["spans"]
    slam = runs[True]["slam"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            assert s.request == p.request
        else:
            assert s.name in ("frame", "terminate")
    frames = [s for s in spans if s.name == "frame"]
    assert [s.request for s in frames] == [(slam.trace_id, t) for t in range(FRAMES)]
    (term,) = [s for s in spans if s.name == "terminate"]
    assert term.request == (slam.trace_id, "terminate")
    names = {s.name for s in spans}
    children = {s.name for s in spans if s.parent and by_id[s.parent].name == "frame"}
    assert FRAME_CHILDREN <= children
    assert {"upload.image", "upload.intrinsics", "upload.edge_set", "upload.keyframe",
            "wait.keyframe", "wait.motion_probe", "wait.terminate"} <= names
    for s in spans:
        if s.name == "window_ba":  # on the CPU every window BA is eager (no CUDA graph)
            assert s.counts == {"window_ba.eager": 1}
        if s.name == "edge_forward":
            assert set(s.attrs) == {"E", "n_depths"}
            assert all(type(v) is int and v > 0 for v in s.attrs.values())
        if s.name.startswith(("wait.", "upload.")):
            assert s.counts == {}  # nothing blocks on the CPU


def test_poses_and_sync_counts_equal_with_the_recorder_on_and_off(runs):
    on, off = runs[True], runs[False]
    assert off["spans"] == []
    assert np.array_equal(on["poses"], off["poses"])
    assert on["syncs"] == off["syncs"]
    # the counts in the spans are the counter's
    assert program_trace.counted(on["spans"], "sync.", frames_only=True) == sum(on["syncs"])


def test_blocking_sites_count_syncs_on_a_card_only():
    card, cpu = SimpleNamespace(type="cuda"), torch.device("cpu")
    before = trace.COUNTS.get("sync.test", 0)
    with trace.blocked("upload", "test", card, 3), trace.blocked("wait", "test", cpu, 5):
        pass
    assert trace.COUNTS["sync.test"] == before + 3
    trace.enable()
    try:
        with trace.span("frame", request=(0, 0)):
            with trace.blocked("upload", "test", card, 3):
                pass
            with trace.blocked("wait", "test", cpu):
                pass
    finally:
        spans, counts = trace.drain()
        trace.disable()
    assert [(s.name, s.counts, s.request) for s in spans] == [
        ("upload.test", {"sync.test": 3}, (0, 0)), ("wait.test", {}, (0, 0)), ("frame", {}, (0, 0))]
    assert counts == {"sync.test": 3}
    assert program_trace.counted(spans, "sync.", frames_only=True) == 3


def test_global_ba_round_attributes_under_loop_closure(loop_run):
    spans = loop_run["spans"]
    by_id = {s.id: s for s in spans}
    rounds = [s for s in spans if s.name == "gba.round"]
    assert len(rounds) >= 12
    assert {r.request[1] == "terminate" for r in rounds} == {True, False}
    for r in rounds:
        assert {"E", "kpairs", "nfree", "ninac"} <= set(r.attrs)
        assert r.attrs["E"] > 0 and r.attrs["kpairs"] > 0 and r.attrs["nfree"] > 0
        kids = [s.name for s in spans if s.parent == r.id]
        assert kids == ["gba.normalize", "gba.sparsity", "gba.solve"]
    assert any(s.name == "loop.proposal" and by_id[s.parent].name == "frame" for s in spans)
    means = program_trace.round_means(spans)
    assert means["kpairs"] > 0 and means["nfree"] > 0


def test_record_function_lands_inside_its_span_on_the_profilers_clock():
    from bench_port.trace_run import trace_start_ns

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    trace.enable()
    try:
        with trace.span("outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
            time.sleep(0.002)
    finally:
        (outer,), _ = trace.drain()
        trace.disable()
    prof.stop()
    t0 = trace_start_ns(prof)
    (ev,) = [e for e in prof.events() if e.name == "inner"]
    start, end = t0 + ev.time_range.start * 1000, t0 + ev.time_range.end * 1000
    assert outer.t0_ns <= start <= end <= outer.t1_ns


def test_kernel_launch_counts_go_through_the_recorder():
    before = dict(kernels.LAUNCHES)
    kernels.count("corr")
    assert kernels.LAUNCHES["corr"] == before["corr"] + 1
    assert trace.COUNTS["launch.corr"] == kernels.LAUNCHES["corr"]
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    trace.enable()
    try:
        with trace.span("s"):
            kernels.count("segsum")
    finally:
        (s,), counts = trace.drain()
        trace.disable()
    assert s.counts == {"launch.segsum": 1} and counts == {"launch.segsum": 1}
    with pytest.raises(KeyError):
        kernels.count("no_such_kernel")
    kernels.reset_launches()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)
    assert list(kernels.LAUNCHES) == list(before)


def test_timer_records_its_region_as_a_span(capsys):
    from dpvo_tpu_torch.utils import Timer, timer

    trace.enable()
    try:
        with Timer("timed", sync="cpu"):
            with trace.span("inside"):
                pass
        with Timer("quiet", enabled=False):
            pass
    finally:
        spans, _ = trace.drain()
        trace.disable()
    assert [s.name for s in spans] == ["inside", "timed", "quiet"]
    assert spans[0].parent == spans[1].id
    assert capsys.readouterr().out.startswith("timed ")
    assert "quiet" not in timer.all_times


def _span(i, parent, name, t0, t1, request=(0, 1), counts=None):
    return trace.Span(i, parent, name, t0, t1, request, {}, counts or {})


def test_self_time_arithmetic():
    spans = [_span(2, 1, "topology", 10, 30), _span(3, 2, "upload.edge_set", 20, 25,
                                                    counts={"sync.edge_set": 16}),
             _span(4, 1, "keyframe", 40, 90), _span(5, 4, "wait.keyframe", 80, 95),
             _span(1, 0, "frame", 0, 100),
             _span(7, 6, "topology", 110, 120, request=(0, "terminate")),
             _span(6, 0, "terminate", 100, 200, request=(0, "terminate"))]
    own = program_trace.self_times_ns(spans)
    # a child reaching past its parent covers only its part inside
    assert own == {1: 100 - 20 - 50, 2: 15, 3: 5, 4: 40, 5: 15, 6: 90, 7: 10}
    assert program_trace.self_ms(spans, {"topology"}) == pytest.approx(25e-6)
    assert program_trace.self_ms(spans, {"topology"}, frames_only=True) == pytest.approx(15e-6)
    assert program_trace.span_ms(spans, ("wait.", "upload."), True) == pytest.approx(20e-6)
    assert program_trace.counted(spans, "sync.", frames_only=True) == 16
