"""The readers of the port's spans and counters (``program_trace.py``,
``metrics/<name>.py``) on fixed span lists, the device-idle attribution
on a synthetic profile, and the stream runner's recorder hook on the
tiny cell."""

from __future__ import annotations

from collections import namedtuple

import pytest

from bench_port import program_trace
from bench_port.run import read_metric
from bench_port.tests import tiny

ROOT = tiny.ROOT
Span = namedtuple("Span", "id parent name t0_ns t1_ns request attrs counts")
MS = 1_000_000
F0, F1, TERM = (7, 0), (7, 1), (7, "terminate")


def _spans():
    """Two frames of 100 ms and a terminate of 400 ms (times in ms)."""
    rows = [  # id, parent, name, t0, t1, request, attrs, counts
        (2, 1, "keyframe.decide", 0, 4, F0, {}, {}),
        (3, 1, "topology", 10, 20, F0, {}, {}),
        (4, 3, "upload.edge_set", 15, 18, F0, {}, {"sync.edge_set": 16}),
        (5, 1, "keyframe", 80, 90, F0, {}, {}),
        (6, 5, "wait.keyframe", 85, 89, F0, {}, {"sync.keyframe": 1}),
        (1, 0, "frame", 0, 100, F0, {}, {}),
        (8, 7, "topology", 110, 116, F1, {}, {}),
        (9, 7, "gba.round", 120, 180, F1, dict(E=1000, kpairs=5000, nfree=40, ninac=600), {}),
        (10, 9, "gba.sparsity", 125, 165, F1, {}, {}),
        (11, 10, "upload.gba", 160, 162, F1, {}, {"sync.gba": 23}),
        (7, 0, "frame", 100, 200, F1, {}, {}),
        (13, 12, "gba.round", 210, 310, TERM, dict(E=2000, kpairs=7000, nfree=60, ninac=900), {}),
        (14, 13, "gba.sparsity", 220, 300, TERM, {}, {}),
        (15, 12, "wait.terminate", 500, 505, TERM, {}, {"sync.terminate": 1}),
        (12, 0, "terminate", 200, 600, TERM, {}, {}),
    ]
    return [Span(i, p, n, a * MS, b * MS, r, at, c) for i, p, n, a, b, r, at, c in rows]


@pytest.mark.parametrize("name,want", [
    ("host_topology_ms", (7 + 6) / 2),      # topology self: 10 - 3, then 6
    ("keyframe_ms", (4 + 6) / 2),           # decide 4, keyframe 10 - 4
    ("host_wait_ms", (3 + 4 + 2) / 2),      # frames' waits and uploads only
    ("syncs_per_frame", (16 + 1 + 23) / 2),
    ("gba_sparsity_ms", (38 + 80) / 2),     # 40 - 2, then 80
    ("terminate_ms", 400.0),
])
def test_program_readers_on_a_fixed_span_list(name, want):
    ctx = dict(frames=2, program_spans=_spans(), program_counts={})
    assert read_metric(ROOT, name, ctx) == pytest.approx(want)
    # a run whose port has no recorder: nothing to read, no error
    assert read_metric(ROOT, name, dict(frames=2)) is None


def test_idle_split_between_sibling_spans_and_outside():
    spans = _spans()
    t0 = 1_000_000   # the profile's start, ns; ops in us from it
    us = lambda ms: (ms * MS - t0) / 1000
    # idle: [8, 12] ms (keyframe.decide ended at 4: frame's own 8-10, topology 10-12),
    # [88, 95] (wait.keyframe 88-89, keyframe 89-90, frame 90-95), [620, 640] (no span)
    ops = [("a", us(1), us(8)), ("b", us(12), us(88)), ("c", us(95), us(620)),
           ("d", us(640), us(650))]
    seg = dict(ops=ops, trace_start_ns=t0)
    assert program_trace.idle_intervals(seg) == [(8 * MS, 12 * MS), (88 * MS, 95 * MS),
                                                 (620 * MS, 640 * MS)]
    idle = program_trace.attribute_idle(spans, [seg])
    assert idle == pytest.approx({"frame": 0.002 + 0.005, "topology": 0.002,
                                  "wait.keyframe": 0.001, "keyframe": 0.001,
                                  program_trace.OUTSIDE: 0.020})
    top = program_trace.idle_by_span(spans, [seg], top=2)
    assert top[:2] == [["frame", pytest.approx(0.007)], ["topology", pytest.approx(0.002)]]
    assert top[-1] == [program_trace.OUTSIDE, pytest.approx(0.020)]
    assert program_trace.named_share(spans, [seg]) == pytest.approx(0.004 / 0.031)


def test_innermost_timeline_of_nested_spans():
    line = program_trace.innermost(_spans()[:6])
    assert [(a // MS, b // MS, n) for a, b, n in line] == [
        (0, 4, "keyframe.decide"), (4, 10, "frame"), (10, 15, "topology"),
        (15, 18, "upload.edge_set"), (18, 20, "topology"), (20, 80, "frame"),
        (80, 85, "keyframe"), (85, 89, "wait.keyframe"), (89, 90, "keyframe"),
        (90, 100, "frame")]


def test_round_means_and_syncs_by_site():
    spans = _spans()
    assert program_trace.round_means(spans) == dict(E=1500, kpairs=6000, nfree=50, ninac=750)
    assert program_trace.syncs_by_site(spans) == {"sync.edge_set": 8, "sync.gba": 11.5,
                                                  "sync.keyframe": 0.5}


def test_trace_run_on_the_tiny_cell(tmp_path):
    """The stream runner turns the port's recorder on over a traced run's
    window and hands its spans and counts to the readers; an untraced run
    leaves it off and gives them None."""
    import json
    import time

    import torch

    from bench_port.run import load_cell, load_module

    root = tiny.make_root(tmp_path)
    cell, config, traffic = load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                                      tiny.CELL, root)
    stream = load_module(root, "runners", "stream")
    out = {trace: stream.run(cell, config, traffic, 5, 4.0, trace, torch.device("cpu"), root,
                             lambda s: None, time.perf_counter()) for trace in (True, False)}
    off = out[False]["ctx"]
    assert off["program_spans"] is None and off["program_counts"] is None and off["frames"] == 40
    on = out[True]["ctx"]
    assert {s.name for s in on["program_spans"]} >= {"frame", "topology", "keyframe",
                                                    "terminate"}
    assert out[True]["correct"] and on["frames"] == 40
    program = {name: read_metric(root, name, on) for name in (
        "host_topology_ms", "keyframe_ms", "host_wait_ms", "syncs_per_frame", "gba_sparsity_ms",
        "terminate_ms")}
    assert program.pop("gba_sparsity_ms") is None   # no loop closure in this cell
    assert all(v is not None for v in program.values())
    # nothing blocks on the CPU: the sync count is the card's
    assert program["syncs_per_frame"] == 0
