"""The yardstick: the bound arithmetic, the ``sd_unet`` family's reckoned
kernel calls and model FLOPs, and the idle share from the union of busy
intervals."""

import json
from types import SimpleNamespace

import pytest

import h100bench_tiny as tiny
from conftest import BENCH, CHECKOUT
from hb import roofline
from hb.report import Reading, _module
from hb.trace import WINDOW, DeviceOp, Trace


def load(path):
    return json.loads((CHECKOUT / path).read_text())


SD15, SDXL = load("h100bench/configs/sd15.json"), load("h100bench/configs/sdxl.json")
DPM50 = load("h100bench/traffic/t2i-dpm50-512.json")
EULER30 = load("h100bench/traffic/t2i-euler30-1024.json")
LCM4 = load("h100bench/traffic/lcm4-map-512.json")
SD_UNET = tiny.family()


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("cfg,traffic,k1,k2", [
    (SD15, DPM50, {(2, 8, 4096, 4096, 40): 250}, 21),
    (SDXL, EULER30, {(2, 10, 4096, 4096, 64): 300, (2, 20, 1024, 1024, 64): 1800}, 31),
    (SD15, LCM4, {(1, 8, 4096, 4096, 40): 20}, 21),
])
def test_reckoned_calls_are_the_launches_the_port_counts(cfg, traffic, k1, k2):
    """The counts chip_smoke.py and the port's card runs read: K1 250 an
    SD1.5 image, 2,100 an SDXL one (300 + 1,800), K2 21 and 31."""
    calls = SD_UNET.kernel_calls(cfg, traffic)
    assert calls["flash_attention"] == k1
    assert sum(calls["conv3x3"].values()) == k2


def test_k1_bound_of_one_sd15_call():
    flops = 4 * 2 * 8 * 4096 * 4096 * 40
    one = {(2, 8, 4096, 4096, 40): 1}
    assert roofline.k1_bound_s(one) == pytest.approx(flops / 989e12)
    # PERF.md's kernel table: 0.0434 ms at (2, 8, 4096, 40)
    assert roofline.k1_bound_s(one) * 1e3 == pytest.approx(0.0434, abs=1e-4)


def trace(ops, window=(0, 100)):
    return Trace([DeviceOp(n, s, e, r) for n, s, e, r in ops], [(window[0], window[1], WINDOW)],
                 window, 0)


def test_busy_is_the_union_of_intervals_clipped_to_the_window():
    t = trace([("a", 10, 30, ""), ("b", 20, 40, ""), ("c", 50, 60, ""), ("d", 90, 120, "")])
    assert t.busy_intervals() == [(10, 40), (50, 60), (90, 100)]
    assert t.busy_s == pytest.approx(50e-9)
    assert t.window_s == pytest.approx(100e-9)
    r = Reading(SimpleNamespace(cfg=SD15, traffic=DPM50), SimpleNamespace(trace=t))
    assert _module(BENCH / "metrics" / "device_idle_pct.serve.py").read(r) == pytest.approx(50.0)


def test_a_device_op_belongs_to_the_window_that_launched_it():
    """The profiler's device times can sit off the host's clock: an op
    launched in the window and placed after its end is the window's (and
    misplaced); one launched before it and placed inside is not."""
    t = Trace([DeviceOp("late", 90, 130, "", 50), DeviceOp("early", 5, 20, "", -30),
               DeviceOp("k", 10, 30, "", 8), DeviceOp("no launch", 40, 60, "")],
              [(0, 100, WINDOW)], (0, 100), 1)
    assert [o.name for o in t.window_ops()] == ["late", "k", "no launch"]
    assert t.misplaced() == 1
    assert t.busy_intervals() == [(10, 30), (40, 60), (90, 100)]
    assert [n for n, _ in t.breakdown()["device_ops"]] == ["late", "k", "no launch"]


def test_kernel_roofline_reads_rows_the_device_clock_placed_outside_the_window():
    """K1's rows of the last eval, launched in the window and placed after
    its end (as a traced SDXL stretch on the card had them), still count."""
    k1 = _module(BENCH / "metrics" / "k1_roofline.py")
    ns = 100_000
    rows = [DeviceOp("flash_fwd_kernel<40, 3>", i * ns, (i + 1) * ns, "unet", 0)
            for i in range(250)]
    r = reading(SD15, DPM50, [], {"flash_attention": 250})
    r.trace = r.win.trace = Trace(rows, [(0, 200 * ns, WINDOW)], (0, 200 * ns), 0)
    calls = SD_UNET.kernel_calls(SD15, DPM50)["flash_attention"]
    assert k1.read(r) == pytest.approx(100 * roofline.k1_bound_s(calls) / (250 * ns * 1e-9))


def test_breakdown_names_the_host_range_of_each_gap():
    t = Trace([DeviceOp("k", 10, 40, "unet"), DeviceOp("k", 70, 100, "unet")],
              [(0, 100, WINDOW), (0, 60, "unet"), (60, 100, "vae")], (0, 100), 0)
    b = t.breakdown()
    assert b["device_ops"] == [["k", 60e-9]]
    assert b["idle_gaps"] == [["unet", 30e-9], ["unet", 10e-9]]


def reading(cfg, traffic, ops, launches, traced=1):
    win = SimpleNamespace(trace=None, traced=traced, launches=launches, calls={})
    r = Reading(SimpleNamespace(cfg=cfg, traffic=traffic, family=SD_UNET), win)
    r.trace = win.trace = trace(ops, (0, 10**12))
    return r


def k2_rows(n, ns=100_000):
    return [("conv3x3_kernel<...>", i * ns, (i + 1) * ns, "vae") for i in range(n)]


def test_kernel_roofline_reads_nothing_from_a_stale_count():
    k2 = _module(BENCH / "metrics" / "k2_roofline.py")
    good = k2.read(reading(SD15, DPM50, k2_rows(21), {"conv3x3": 21}))
    calls = SD_UNET.kernel_calls(SD15, DPM50)["conv3x3"]
    expected = 100 * roofline.k2_bound_s(calls) / (21 * 100e-6)
    assert good == pytest.approx(expected)
    assert k2.read(reading(SD15, DPM50, k2_rows(20), {"conv3x3": 21})) is None
    assert k2.read(reading(SD15, DPM50, k2_rows(21), {"conv3x3": 22})) is None


@pytest.mark.parametrize("cfg,traffic,unet_tf,decode_tf", [
    (SD15, DPM50, 1.607, 2.515),
    (SDXL, EULER30, 13.52, 10.47),
])
def test_flop_counts_of_the_reference_on_meta(cfg, traffic, unet_tf, decode_tf):
    """The counts of the port's models on the meta device with the kernels
    off: SD1.5's UNet eval 1.607 TFLOP at CFG batch 2 and its decode 2.515,
    SDXL's 13.52 and 10.47."""
    f = SD_UNET.request_flops(cfg, traffic)
    assert f["unet_eval"] / 1e12 == pytest.approx(unet_tf, rel=2e-3)
    assert f["decode"] / 1e12 == pytest.approx(decode_tf, rel=2e-3)
    assert f["request"] == f["text"] + traffic["steps"] * f["unet_eval"] + f["decode"]


def test_a_traced_run_reads_its_metrics_without_a_card():
    """The traced path on the CPU: the range counts and the program's
    counters are read; a metric of device ops reads nothing where no device
    op was traced, never 0."""
    import dataclasses

    from hb.report import read_metrics

    c = dataclasses.replace(tiny.cell(tiny.SD, tiny.DPM), trace=True)
    d = tiny.driver(c)
    w = d.window(d.setup())
    assert w.traced == 1 and w.calls["unet"] == tiny.DPM["steps"] and w.calls["vae"] == 1
    entries = [m for m in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["per_layer"]
               if "sd15-t2i-dpm50" in m["workloads"]]
    got = read_metrics(entries, BENCH / "metrics", Reading(c, w))
    assert got["kernel_launches_per_image"]["value"] == 0  # the CPU runs the plain forms
    assert not set(got) & {"unet_eval_ms", "k1_roofline", "device_idle_pct.serve",
                           "mfu.serve", "plain_elementwise_ms.serve", "host_syncs_per_image"}


def test_host_syncs_leave_out_the_sync_that_ends_the_window():
    """The runtime's waiting calls in the window, by name with or without a
    version suffix, less the one inside the benchmark's own sync range."""
    from hb.trace import OWN_SYNC

    ranges = [(0, 100, WINDOW), (10, 40, "request"), (90, 99, OWN_SYNC)]
    t = Trace([], ranges, (0, 100), 0, syncs=[5, 20, 30, 95, 150], runtime_calls=9)
    assert t.host_syncs() == 3
    r = Reading(SimpleNamespace(cfg=SD15, traffic=DPM50), SimpleNamespace(traced=3, trace=t))
    assert _module(BENCH / "metrics" / "host_syncs_per_image.py").read(r) == pytest.approx(1.0)


def test_sync_calls_are_known_by_their_base_names():
    from hb.trace import SYNC_CALLS, VERSION

    assert VERSION.sub("", "cudaStreamSynchronize_v3020") in SYNC_CALLS
    assert VERSION.sub("", "cudaDeviceSynchronize") in SYNC_CALLS
    assert VERSION.sub("", "cudaMemcpyAsync_v3020") not in SYNC_CALLS


def test_a_retried_stretch_reads_what_a_single_one_reads(monkeypatch):
    """Where the first trace of a stretch loses rows, it is traced again,
    and everything read is read from the last trace alone."""
    import dataclasses

    from hb import drive
    from hb.report import read_metrics

    entries = [m for m in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["per_layer"]
               if "sd15-t2i-dpm50" in m["workloads"]]

    def traced(retry):
        looks = []

        def lost(w):
            looks.append(1)
            return {"flash_attention": (1, 0)} if retry and len(looks) == 1 else {}

        monkeypatch.setattr(drive, "lost_rows", lost)
        c = dataclasses.replace(tiny.cell(tiny.SD, tiny.DPM), trace=True)
        d = tiny.driver(c)
        w = d.window(d.setup())
        assert len(looks) == (2 if retry else 1)
        return w, read_metrics(entries, BENCH / "metrics", Reading(c, w))

    once, again = traced(False), traced(True)
    assert once[0].calls == again[0].calls and once[0].traced == again[0].traced
    assert once[0].launches == again[0].launches
    assert once[1] == again[1]


@pytest.mark.parametrize("traffic,key", [(DPM50, "batch"), (LCM4, "batch"),
                                         (load("h100bench/traffic/lora-train-b4.json"),
                                          "betas")])
def test_a_traffic_key_that_no_driver_reads_is_refused(traffic, key):
    """A key such as a serving batch (every request is one image) or
    AdamW's betas (the program's own are compared) would have no effect."""
    import dataclasses

    c = dataclasses.replace(tiny.cell(tiny.SD, dict(traffic, **{key: 4})))
    with pytest.raises(ValueError, match=key):
        tiny.driver(c)
    tiny.driver(tiny.cell(tiny.SD, traffic))  # the file as it is
