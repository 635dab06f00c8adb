"""Quality-management parity with the base renderer's scheduling loop
(CBaseVideoRenderer2::ShouldDrawSampleNow / SendQuality,
Source/renbase2.cpp:363-753): synthetic late/early schedules must reproduce
the reference's decisions."""

import numpy as np

from videorenderer.runner import PresentClock, QualityManager
from videorenderer.stats import Metrics

DUR = 1.0 / 60.0


def _frame_times(n, late=0.0, start=10.0):
    """(start_s, end_s, now_s) triples for n frames arriving ``late`` s
    after their stamps (monotonic epoch well past the monitor bias)."""
    for i in range(n):
        s = start + i * DUR
        yield s, s + DUR, s + late


def test_on_time_schedule_never_drops():
    qm = QualityManager()
    decisions = [qm.should_draw(s, e, now)[0]
                 for s, e, now in _frame_times(50, late=0.0)]
    assert "drop" not in decisions
    assert qm.dropped == 0


def test_slightly_early_frames_wait():
    qm = QualityManager()
    # 15 ms early (still ~7 ms early after the monitor bias): wait until due
    decisions = [qm.should_draw(s, e, now)[0]
                 for s, e, now in _frame_times(50, late=-0.015)]
    assert set(decisions) == {"wait"}
    assert qm.dropped == 0


def test_expensive_render_and_late_frames_drop():
    # renders cost most of the frame time (3*render_avg > frame_avg) and
    # every frame arrives over half a duration late with no supplier help:
    # the loop must start dropping (renbase2.cpp:604-621)
    qm = QualityManager()
    t = 10.0
    dropped = []
    for i in range(30):
        s = t + i * DUR
        d, _ = qm.should_draw(s, s + DUR, s + 0.6 * DUR)
        dropped.append(d == "drop")
        if d != "drop":
            qm.on_render_start(now=s)
            qm.on_render_end(now=s + 0.9 * DUR)   # blt eats ~90% of the frame
    assert any(dropped[2:]), "late frames with expensive renders must drop"


def test_frame_after_drop_plays_asap_and_earliness_slides():
    qm = QualityManager()
    # prime with expensive renders + late frames so the drop gate engages
    s = 10.0
    for _ in range(8):
        d, _ = qm.should_draw(s, s + DUR, s + 0.6 * DUR)
        if d != "drop":
            qm.on_render_start(now=s)
            qm.on_render_end(now=s + 0.9 * DUR)
        s += DUR
    while qm.n_normal != -1:
        qm.should_draw(s, s + DUR, s + 0.6 * DUR)
        s += DUR
    # next frame arrives 20 ms early (-12 ms after bias): just dropped ->
    # play it AT ONCE and latch the earliness (renbase2.cpp:640-650,665-690)
    d, _ = qm.should_draw(s, s + DUR, s - 0.020)
    assert d == "draw"
    assert qm.n_normal == 0
    assert np.isclose(qm.earliness, -0.012)


def test_earliness_graceful_slide_exact():
    qm = QualityManager()
    qm.n_normal = 0
    qm.earliness = -0.008
    # a frame earlier than the current earliness and not late: slide by 1/8
    s = 10.0
    qm.should_draw(s, s + DUR, s - 0.018)   # late = -0.010 after bias
    assert np.isclose(qm.earliness, -0.008 + 0.008 / 8)


def test_quality_messages_famine_when_late():
    msgs = []
    qm = QualityManager(quality_sink=lambda m: (msgs.append(m), False)[1])
    for s, e, now in _frame_times(10, late=0.1):
        qm.should_draw(s, e, now)
    # renders are free here -> the supplier is the bottleneck: famine, and
    # the rate request backs off toward 1000 - late_ms (clamped >= 500);
    # the monitor bias adds 8 ms to the effective lateness
    assert msgs[-1].kind == "famine"
    # renders are free so late_s == the effective lateness exactly
    assert msgs[-1].proportion == max(500, 1000 - int(msgs[-1].late_s * 1000))
    assert 500 <= msgs[-1].proportion < 1000
    assert msgs[-1].late_s > 0


def test_quality_messages_speed_up_when_early():
    msgs = []
    qm = QualityManager(quality_sink=lambda m: (msgs.append(m), False)[1])
    for s, e, now in _frame_times(30, late=-0.012):
        qm.should_draw(s, e, now)
    # consistently early: proportion rises above 1000 (up to 2000)
    assert msgs[-1].proportion > 1000
    assert msgs[-1].proportion <= 2000


def test_supplier_handling_quality_tolerates_4_durations():
    # supplier says "I'm handling it": frames up to 4 durations late still
    # draw (renbase2.cpp:610-613) even with expensive renders
    qm = QualityManager(quality_sink=lambda m: True)
    for i in range(8):
        s = 10.0 + i * DUR
        d, _ = qm.should_draw(s, s + DUR, s + 3.5 * DUR)
        assert d == "draw"
        qm.on_render_start(now=s)
        qm.on_render_end(now=s + 0.9 * DUR)
    qm2 = QualityManager(quality_sink=lambda m: False)
    decisions = []
    for i in range(8):
        s = 10.0 + i * DUR
        d, _ = qm2.should_draw(s, s + DUR, s + 3.5 * DUR)
        decisions.append(d)
        if d != "drop":
            qm2.on_render_start(now=s)
            qm2.on_render_end(now=s + 0.9 * DUR)
    assert "drop" in decisions


def test_drops_flow_into_metrics():
    m = Metrics()
    qm = QualityManager(metrics=m)
    for i in range(20):
        s = 10.0 + i * DUR
        d, _ = qm.should_draw(s, s + DUR, s + 0.6 * DUR)
        if d != "drop":
            qm.on_render_start(now=s)
            qm.on_render_end(now=s + 0.9 * DUR)
    assert m.draw_stats.drops == qm.dropped > 0
    assert m.snapshot()["frames_dropped"] == qm.dropped
    # lateness flowed into the sync accumulators
    assert m.render_stats.sync_count > 0


def test_render_time_spike_rejected():
    qm = QualityManager()
    # the first measurement only seeds render_last (avg and last start 0, so
    # nothing is < 32x of them — same as the reference's cold start)
    qm.on_render_start(now=0.0)
    qm.on_render_end(now=0.005)
    assert qm.render_avg == 0.0 and qm.render_last == 0.005
    qm.on_render_start(now=0.1)
    qm.on_render_end(now=0.105)
    avg = qm.render_avg
    assert avg > 0
    qm.on_render_start(now=1.0)
    qm.on_render_end(now=2.0)     # 1 s spike (>32x): must not enter the avg
    assert qm.render_avg == avg
    assert qm.render_last == 1.0


def test_present_clock_schedule_realtime():
    pc = PresentClock(fps=500.0)
    rendered = sum(pc.schedule(i) for i in range(20))
    assert rendered == 20
    assert pc.dropped == 0
    # the sleeps paced us to ~the stream clock
    assert pc.quality.drawn == 20


def test_present_clock_quality_sink_wired():
    msgs = []
    pc = PresentClock(fps=1000.0,
                      quality_sink=lambda m: (msgs.append(m), False)[1])
    for i in range(5):
        pc.schedule(i)
    assert len(msgs) == 5
