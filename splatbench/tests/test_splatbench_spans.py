"""yardstick/spans.py on a synthetic trace: the clocks' offset from the
first marker's launch, operations put down to the span open at their
launch (by correlation id, the engine thread's to the main thread's),
one operation without a launch event, idle gaps by the span of the
operation after them and outside any span, and the readings: idle_gaps,
span_device_ms, adam's device ms and the host ms a step."""
from collections import namedtuple

import pytest

from splatbench.yardstick import spans as sp

Span = namedtuple("Span", "id name thread parent start_ns end_ns")
MAIN, ENGINE = 11, 22
OFFSET = 1000.0  # trace us minus host us


def _ev(cat, name, ts, dur, corr, tid=MAIN):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _trace():
    """Host (us): step 0 at 100-300: step.render 110-150 (launch of op
    a at 115, the stream total read at 141-149), step.adam 200-260
    (launch of b at 210), an engine-thread launch at 160 (op c, in
    step.backward 150-200 on the main thread),
    and op d with no launch event, starting on the device at 275 + 1000
    (main thread: step.stats 262-290). Markers launched at 90 and 305
    (outside spans), the probe at 400 in its own span."""
    ev = [
        # markers: launch on the host, kernel on the device
        _ev("cuda_runtime", "cudaLaunchKernel", 90 + OFFSET, 2, 1),
        _ev("kernel", "void at::native::spin_kernel(long)", 95 + OFFSET,
            1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 305 + OFFSET, 2, 9),
        _ev("kernel", "void at::native::spin_kernel(long)", 320 + OFFSET,
            1, 9),
        # ops
        _ev("cuda_runtime", "cudaLaunchKernel", 115 + OFFSET, 2, 2),
        _ev("kernel", "void render_kernel<float>(int)", 130 + OFFSET, 10,
            2),
        _ev("cuda_runtime", "cudaLaunchKernel", 160 + OFFSET, 2, 3,
            ENGINE),
        _ev("kernel", "void backward_kernel()", 165 + OFFSET, 20, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 210 + OFFSET, 2, 4),
        _ev("kernel", "void adam_kernel()", 215 + OFFSET, 30, 4),
        _ev("kernel", "osk_ctypes_kernel", 280 + OFFSET, 5, 5),
        # the probe after the window
        _ev("cuda_runtime", "cudaLaunchKernel", 401 + OFFSET, 2, 10),
        _ev("kernel", "void at::native::spin_kernel(long)", 405 + OFFSET,
            50, 10),
    ]
    us = 1000  # ns
    spans = [
        Span(0, "trainer.run_step", MAIN, None, 100 * us, 300 * us),
        Span(1, "step", MAIN, 0, 105 * us, 295 * us),
        Span(2, "step.render", MAIN, 1, 110 * us, 150 * us),
        Span(3, "step.backward", MAIN, 1, 150 * us, 200 * us),
        Span(4, "step.adam", MAIN, 1, 200 * us, 260 * us),
        Span(5, "step.stats", MAIN, 1, 262 * us, 290 * us),
        Span(6, "sync.pose", MAIN, 0, 101 * us, 104 * us),
        Span(7, "sync.stream_total", MAIN, 2, 141 * us, 149 * us),
        Span(8, "probe", MAIN, None, 400 * us, 460 * us),
    ]
    return ev, spans


def test_offset_attribution_and_gaps():
    ev, spans = _trace()
    tl, probe = sp.without_last_marker(sp.timeline_of(ev))
    assert probe[3] == 10
    # the first marker's clock read 3 us late (its launch seems early),
    # the second's right: the median of two is their mean
    off, how = sp.offset_us(tl, [93 * 1000, 305 * 1000])
    assert how == "launch" and off == pytest.approx(OFFSET - 1.5)
    # a read whose marker the trace dropped pairs with no launch
    off, _ = sp.offset_us(tl, [90 * 1000, 200 * 1000, 305 * 1000])
    assert off == pytest.approx(OFFSET)
    assert sp.launch_latency_us(tl) == pytest.approx(5.0)
    names = sp.attribute(tl, spans, off)
    by_corr = {d[3]: n for d, n in zip(tl.device, names)}
    assert by_corr[2] == "step.render"
    assert by_corr[3] == "step.backward"  # the engine thread's launch
    assert by_corr[4] == "step.adam"
    # d has no launch: its device start 280 less 5 us is 275, step.stats
    assert by_corr[5] == "step.stats"
    assert by_corr[1] is None and by_corr[9] is None  # markers

    trace, att = sp.attribute_window(tl, spans, off)
    assert trace.steps == 1 and trace.window == (96 + OFFSET, 320 + OFFSET)
    dev = dict(att.span_device_ms())
    assert dev == pytest.approx({"step.adam": 0.030, "step.backward": 0.020,
                                 "step.render": 0.010, "step.stats": 0.005})
    # gaps: 96-130 before a, 140-165 before c, 185-215 before b, 245-280
    # before d, 285-320 before the last marker (outside every span)
    idle = dict(att.idle_gaps())
    assert idle == pytest.approx({"step.render": 34e-6,
                                  "step.backward": 25e-6,
                                  "step.adam": 30e-6, "step.stats": 35e-6,
                                  "outside:at::native::spin_kernel": 35e-6})
    assert att.named_idle_share() == pytest.approx(124 / 159)
    assert sum(idle.values()) + trace.busy_s() == pytest.approx(
        trace.window_s)


def test_offset_from_device_start_without_launch_events():
    ev, spans = _trace()
    ev = [e for e in ev if e["cat"] == "kernel"]
    tl, _ = sp.without_last_marker(sp.timeline_of(ev))
    off, how = sp.offset_us(tl, [90 * 1000])
    assert how == "device_start"
    assert off == pytest.approx(95 + OFFSET - sp.LAUNCH_US - 90)
    assert sp.launch_latency_us(tl) == sp.LAUNCH_US
    names = sp.attribute(tl, spans, off)
    # every op by its device start less the latency, on the main thread
    assert names[1:5] == ["step.render", "step.backward", "step.adam",
                          "step.stats"]


def test_host_ms_less_step_and_syncs():
    _, spans = _trace()
    # trainer.run_step 200 us less step (190) less sync.pose (3)
    assert sp.host_ms(spans, "trainer.run_step", "step") == \
        pytest.approx(0.007)
    # step 190 us less sync.stream_total (8)
    assert sp.host_ms(spans, "step") == pytest.approx(0.182)
    assert sp.host_ms(spans, "nothing") is None
