"""The readers of the program's own instrumentation
(``harness/program.py`` and the metrics that use it) on synthetic traces
and on spans opened under a CPU profiler: the step's busy time by stage
mark, the runner's host time from nested spans, the graph
cache's build seconds, and every reader that was there before reading the
same with and without program spans in the trace."""

import time

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import program, spec as spec_mod, trace

ACCEPTED = ("step_device_ms.offline", "ba_device_ms", "device_activities.offline",
            "device_activities.ba", "fast_cand_roofline", "klt_level_roofline",
            "device_idle_share.offline", "device_idle_share.ba")


def _mark(stage, s):
    return (f"stage_mark_{stage}_kernel", s, s + 1)


def test_stage_attribution_by_the_last_mark():
    dev = [
        ("upload", 0, 10),  # before the first mark: dispatch
        _mark("frontend", 10), ("fast", 11, 20), ("klt", 20, 30),
        _mark("estimate", 30), ("lmeds", 31, 60), ("lmeds2", 50, 70),  # overlap once
        _mark("refine", 70), ("lm", 71, 80),
        _mark("end", 80), ("clone", 81, 85), ("fetch", 90, 95),  # end..frontend: dispatch
        _mark("frontend", 100), ("fast", 101, 110),
        _mark("estimate", 110), ("lmeds", 111, 120),
        _mark("refine", 120), ("lm", 121, 130), _mark("end", 130),
    ]
    got = program.stage_busy_s(dev)
    assert got == pytest.approx({"frontend": 30e-6, "estimate": 50e-6, "refine": 20e-6,
                                 "dispatch": 21e-6})
    t = trace.summarize(dev, [], calls=2, window_s=1e-3)
    assert sum(got.values()) == pytest.approx(t.busy_s)
    # Order of the list does not matter; a trace without marks reads nothing.
    assert program.stage_busy_s(list(reversed(dev))) == pytest.approx(got)
    assert program.stage_busy_s([("fast", 0, 10)]) is None


@pytest.fixture
def fresh_totals(monkeypatch):
    from epivo_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPAN_TOTALS", {})
    return profiling


def test_runner_host_and_wait_from_nested_spans(fresh_totals):
    span = fresh_totals.span
    with profile(activities=[ProfilerActivity.CPU]):
        with span("vo.sequence", seed=1):
            for b in range(2):
                with span("vo.stack", b=b, frame=2 * b):
                    time.sleep(0.002)
                with span("vo.dispatch", b=b, frame=2 * b):
                    with span("graph.fill"):
                        time.sleep(0.001)
                    with span("graph.replay"):
                        time.sleep(0.003)
            for b in range(2):
                with span("vo.fetch", b=b, frame=2 * b):
                    time.sleep(0.005)
                with span("vo.collect", b=b, frame=2 * b):
                    time.sleep(0.001)
    totals = fresh_totals.span_totals()
    assert {k: n for k, (_, n) in totals.items()} == {
        "vo.sequence": 1, "vo.stack": 2, "vo.dispatch": 2, "graph.fill": 2,
        "graph.replay": 2, "vo.fetch": 2, "vo.collect": 2}
    t = trace.summarize([], [], calls=2, window_s=0.1)
    host = spec_mod.reader("runner_host_ms.offline")(t)
    wait = 1e3 * totals["vo.fetch"][0] / 2  # the host's wait in the fetch: left out
    assert wait >= 5.0
    seq = 1e3 * totals["vo.sequence"][0] / 2
    graph = 1e3 * (totals["graph.fill"][0] + totals["graph.replay"][0]) / 2
    assert host == pytest.approx(seq - wait - graph)
    assert 3.0 <= host < seq - wait - 4.0  # stack and collect, not fill and replay


def test_runner_readers_read_nothing_without_runner_spans(fresh_totals, monkeypatch):
    t = trace.summarize([], [], calls=2, window_s=0.1)
    with profile(activities=[ProfilerActivity.CPU]):
        with fresh_totals.span("ba.windows"):
            pass
    read = spec_mod.reader("runner_host_ms.offline")
    assert read(t) is None
    monkeypatch.delattr(fresh_totals, "span_totals")  # a program without spans
    assert read(t) is None


def test_graph_build_s_from_the_totals(monkeypatch):
    from epivo_tpu_torch import _graphs

    t = trace.summarize([], [], calls=1, window_s=0.1)
    monkeypatch.setattr(_graphs, "build_totals", lambda: dict(
        eager=3, eager_s=1.25, captures=2, capture_s=4.5, replays=40, evictions=1))
    assert spec_mod.reader("graph_build_s")(t) == pytest.approx(5.75)
    monkeypatch.delattr(_graphs, "build_totals")  # a program without the totals
    assert spec_mod.reader("graph_build_s")(t) is None


def test_accepted_readers_read_the_same_with_program_spans():
    dev = [("fast_candidates_kernel", 0, 10), ("track_level_kernel", 12, 30),
           ("k", 50, 60), ("fast_candidates_kernel", 100, 110), ("k", 140, 150)]
    harness = [("runner_call", 0, 200)]
    spans = [("vo.sequence", 1, 199), ("vo.dispatch", 2, 40), ("graph.replay", 3, 35),
             ("vo.fetch", 40, 100), ("vo.upload", 110, 140), ("vo.finish", 150, 199)]
    plain = trace.summarize(dev, harness, calls=2, window_s=2e-4)
    spanned = trace.summarize(dev, harness + spans, calls=2, window_s=2e-4)
    for t in (plain, spanned):
        t.wall_per_call_s = 1e-4
        t.bounds.update(fast_cand=4e-6, klt_level=6e-6)
    for name in ACCEPTED:
        read = spec_mod.reader(name)
        assert read(plain) == read(spanned), name
    # The idle gaps are the same stretches, now named by the program's spans.
    assert [s for _, s in plain.idle_gaps] == [s for _, s in spanned.idle_gaps]
    assert {label for label, _ in plain.idle_gaps} == {"runner_call"}
    assert {label for label, _ in spanned.idle_gaps} == {"graph.replay", "vo.fetch",
                                                         "vo.upload"}

