"""The five metrics of the program's spans on a synthetic trace: the four
idle classes partition the window's idle time, a gap that crosses span
boundaries is cut along them, a capture counts as replay but not as replay
host time, other threads are left out, and nothing is read without a
device op or without the program's recorder."""

from types import SimpleNamespace

import pytest

from conftest import BENCH
from hb import spans as hbspans
from hb.report import Reading, _module
from hb.trace import WINDOW, DeviceOp, Trace
from sfast_tpu_torch.profile.spans import Span

METRICS = ("graph_replays_per_image", "replay_host_ms", "idle_in_replay_ms",
           "idle_in_request_ms", "idle_waiting_ms")
SERVING, OTHER = 1, 2


def span(name, start, end, graph=None, thread=SERVING):
    return Span(name, start, end, 1, graph, 0, None, thread)


# one request in a window of [0, 1000) ns: its text encoder's replay, which
# missed and captured, the UNet's replay, and the image's wait
SPANS = [
    span("sfast.request", 100, 900),
    span("sfast.replay", 120, 200, "text_encoder"),
    span("sfast.capture", 130, 180, "text_encoder"),
    span("sfast.replay", 220, 400, "unet"),
    span("sfast.wait", 600, 880),
    # a warm-up thread's capture over the whole window: not the serving thread
    span("sfast.capture", 0, 1000, "unet", thread=OTHER),
]
BUSY = [(150, 250), (300, 380), (420, 650), (700, 750)]  # 460 ns busy, 540 idle


def reading(ops, images=1):
    t = Trace([DeviceOp("k", s, e, "") for s, e in ops], [(0, 1000, WINDOW)], (0, 1000), 0)
    return Reading(SimpleNamespace(cfg={}, traffic={}), SimpleNamespace(trace=t, traced=images))


def read_all(r):
    return {m: _module(BENCH / "metrics" / f"{m}.py").read(r) for m in METRICS}


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(hbspans, "program_spans", lambda: list(SPANS))


def test_the_four_classes_partition_the_idle_time():
    s = hbspans.split_spans([x for x in SPANS if x.thread == SERVING], BUSY, (0, 1000), 1)
    assert s.idle_ns == {hbspans.OUTSIDE: 200, hbspans.REQUEST: 60, hbspans.REPLAY: 100,
                         hbspans.WAITING: 180}
    assert sum(s.idle_ns.values()) == 1000 - sum(e - b for b, e in BUSY)
    # the capture's idle is its replay's graph's
    assert s.replay_idle_ns == {"text_encoder": 30, "unet": 70}
    assert s.replays == {"text_encoder": 1, "unet": 1} and s.waits == 1
    # innermost in a replay: the text encoder's 80 ns less its capture's 50
    assert s.replay_host_ns == 30 + 180


def test_a_gap_that_crosses_span_boundaries_is_cut_along_them():
    # idle [380, 420): the UNet's replay until 400, the request path after
    s = hbspans.split_spans([x for x in SPANS if x.thread == SERVING], [(0, 380), (420, 1000)],
                            (0, 1000), 1)
    assert s.idle_ns[hbspans.REPLAY] == 20 and s.idle_ns[hbspans.REQUEST] == 20
    assert s.replay_idle_ns == {"unet": 20}
    # a span that opens before the window counts from the window's start
    s = hbspans.split_spans([span("sfast.wait", -50, 30)], [(30, 1000)], (0, 1000), 1)
    assert s.idle_ns[hbspans.WAITING] == 30 and s.waits == 0


def test_the_metrics_read_the_serving_thread_per_image(program):
    got = read_all(reading(BUSY, images=2))
    assert got == pytest.approx({"graph_replays_per_image": 1.0,
                                 "replay_host_ms": 105e-6, "idle_in_replay_ms": 50e-6,
                                 "idle_in_request_ms": 30e-6, "idle_waiting_ms": 90e-6})


def test_nothing_is_read_without_a_device_op(program):
    assert read_all(reading([])) == dict.fromkeys(METRICS)


def test_nothing_is_read_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setattr(hbspans, "program_spans", lambda: None)
    assert read_all(reading(BUSY)) == dict.fromkeys(METRICS)


def test_nothing_is_read_without_a_request_in_the_window(monkeypatch):
    monkeypatch.setattr(hbspans, "program_spans",
                        lambda: [x for x in SPANS if x.name != "sfast.request"])
    assert read_all(reading(BUSY)) == dict.fromkeys(METRICS)


def test_the_program_without_the_recorder_is_found_missing(monkeypatch):
    """The parent's checkout: ``sfast_tpu_torch.profile`` without ``spans``."""
    import sys

    import sfast_tpu_torch.profile

    monkeypatch.delattr(sfast_tpu_torch.profile, "spans")
    monkeypatch.setitem(sys.modules, "sfast_tpu_torch.profile.spans", None)
    assert hbspans.program_spans() is None
