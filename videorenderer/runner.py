"""Clip runner: batched, double-buffered frame streaming with temporal state.

The reference's streaming loop (Receive -> CopySample -> Render -> Present,
Source/DX11VideoProcessor.cpp:2143-2200) overlaps CPU upload with GPU work
through the swap-chain queue.  The analogue here:

 * frames are processed in **batches** (clips) — throughput over latency;
 * host->device transfer of batch k+1 is issued (``jax.device_put`` is
   async) while batch k computes — the copy/paint overlap;
 * deinterlacing keeps a past/future frame window across batch boundaries
   (the reference's reference-frame ring, Source/D3D11VP.h:26-193) by
   overlapping consecutive batches with 1-frame halos;
 * A/V-sync accounting (drop-late-frame logic, renbase2.h:46-68 /
   SyncFrameToStreamTime, Source/VideoProcessor.cpp:258-271) is reproduced
   for real-time mode in :class:`PresentClock`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from .stats import Metrics, precise_tick


@dataclass
class ClipResult:
    outputs: list           # list of device arrays (one per batch)
    frames: int
    seconds: float

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0


def run_clip(frame_fn: Callable, batches: Iterable[tuple], device=None,
             metrics: Metrics | None = None) -> ClipResult:
    """Stream plane-batches through a jitted frame function with transfer/
    compute overlap.

    ``batches``: iterable of plane tuples (numpy arrays, leading batch dim).
    """
    device = device or jax.devices()[0]
    fn = frame_fn
    outputs = []
    n_frames = 0
    it = iter(batches)

    def put(b):
        return tuple(jax.device_put(p, device) for p in b)

    t0 = precise_tick()
    try:
        current = put(next(it))
    except StopIteration:
        return ClipResult([], 0, 0.0)

    while True:
        # issue next transfer before waiting on compute (async dispatch)
        nxt = next(it, None)
        pending = put(nxt) if nxt is not None else None
        out = fn(current)
        outputs.append(out)
        n_frames += current[0].shape[0] if current[0].ndim > 2 else 1
        if metrics is not None:
            metrics.draw_stats.frame_drawn()
        if pending is None:
            break
        current = pending
    jax.block_until_ready(outputs[-1])
    return ClipResult(outputs, n_frames, precise_tick() - t0)


def windowed_batches(planes: tuple[np.ndarray, ...], batch: int,
                     halo: int = 0) -> Iterator[tuple]:
    """Split (N, ...) plane arrays into batches with ``halo`` overlap frames
    on each side (temporal window for motion-adaptive deinterlacing)."""
    n = planes[0].shape[0]
    for start in range(0, n, batch):
        lo = max(0, start - halo)
        hi = min(n, start + batch + halo)
        yield tuple(p[lo:hi] for p in planes)


class DeinterlaceSession:
    """Streaming motion-adaptive deinterlacing with one frame of lookahead —
    the reference-frame window of the fixed-function deinterlacer
    (Source/D3D11VP.h:26-193) as a host-side sliding buffer.

    push() returns 0..2 processed output frames per input (2 when
    ``double_rate`` — field 1 is the +duration/2 render); flush() drains the
    last frame with a clamped window.
    """

    def __init__(self, plan, double_rate: bool = True,
                 top_field_first: bool = True, pack_surface: bool = False,
                 post: Callable | None = None):
        """``post``: optional per-frame RGB tail traced into the same jitted
        program as the deinterlace (geometry / user shaders / final dither —
        the post-scale pass ring that follows the VP blt in the reference,
        Source/DX11VideoProcessor.cpp:3337-3428)."""
        import jax as _jax
        from .pipeline import make_deint_fields_fn, make_deint_frame_fn
        self.double_rate = double_rate
        if double_rate:
            # one program for both fields: casts + motion field shared
            inner = make_deint_fields_fn(
                plan, top_field_first=top_field_first,
                pack_surface=pack_surface)
            if post is not None:
                dual = lambda p, c, n: tuple(post(o) for o in inner(p, c, n))
            else:
                dual = inner
            self._dual = _jax.jit(dual)
            self._fns = []
        else:
            self._dual = None
            inner1 = make_deint_frame_fn(
                plan, field=0, top_field_first=top_field_first,
                pack_surface=pack_surface)
            one = ((lambda p, c, n: post(inner1(p, c, n)))
                   if post is not None else inner1)
            self._fns = [_jax.jit(one)]
        self._window: list[tuple] = []  # [prev, cur, next]
        self._tail: tuple | None = None  # batched mode: last 2 stream frames
        self._step_cache: dict = {}      # (first, batch) -> jitted step

    def reset(self) -> None:
        """Drop the temporal window (stream discontinuity / re-Configure —
        the reference's VP ref-frame ring reset on re-init)."""
        self._window = []
        self._tail = None

    def _emit(self, prev, cur, nxt) -> list:
        if self._dual is not None:
            return list(self._dual(prev, cur, nxt))
        return [fn(prev, cur, nxt) for fn in self._fns]

    def push(self, planes: tuple) -> list:
        if self._tail is not None:
            raise RuntimeError("this session is in batched mode "
                               "(push_batch/flush_batch); do not mix APIs")
        planes = tuple(jnp.asarray(p) for p in planes)
        self._window.append(planes)
        if len(self._window) == 1:
            return []
        if len(self._window) == 2:
            # first frame: prev clamps to itself
            a, b = self._window
            return self._emit(a, a, b)
        self._window = self._window[-3:]
        a, b, c = self._window
        return self._emit(a, b, c)

    def flush(self) -> list:
        if self._tail is not None:
            raise RuntimeError("this session is in batched mode; "
                               "use flush_batch()")
        if not self._window:
            return []
        if len(self._window) == 1:
            a = self._window[0]
            return self._emit(a, a, a)
        a, b = self._window[-2:]
        return self._emit(a, b, b)

    # -- batched streaming ---------------------------------------------------
    # Frame-at-a-time push() renders the whole pipeline at batch 1, where
    # per-dispatch overheads dominate at 4K.  The batched variant keeps the
    # same per-frame math (identical sliding window, same clamping) but
    # builds shifted (prev, cur, next) batch views and runs ONE jitted call
    # per field per batch.  Use either push() or push_batch(), not both.

    def push_batch(self, planes: tuple) -> list:
        """``planes``: plane arrays with a leading frame dim (B, ...).
        Returns per-field output batches covering every input frame whose
        one-frame lookahead is available (the rest emit on the next call or
        flush_batch()).  With ``double_rate`` the presentation order
        interleaves field 0 and field 1 of each frame.

        The whole step (window concatenation, shifted views, field
        programs, tail extraction) is ONE jitted program per (stream
        phase, batch) shape: building the window with eager ops would
        cost ~15 separate device dispatches per push."""
        if self._window:
            raise RuntimeError("this session is in streaming mode "
                               "(push/flush); do not mix APIs")
        planes = tuple(jnp.asarray(p) for p in planes)
        first = self._tail is None
        key = (first, planes[0].shape[0])
        step = self._step_cache.get(key)
        if step is None:
            import jax as _jax
            emit = self._emit

            def _step(tail, ps):
                if tail is None:
                    # stream start: the first frame's prev clamps to itself
                    arr = tuple(jnp.concatenate([p[:1], p]) for p in ps)
                else:
                    arr = tuple(jnp.concatenate([t, p])
                                for t, p in zip(tail, ps))
                m = arr[0].shape[0]
                outs = []
                if m >= 3:
                    prev = tuple(p[0:m - 2] for p in arr)
                    cur = tuple(p[1:m - 1] for p in arr)
                    nxt = tuple(p[2:m] for p in arr)
                    outs = emit(prev, cur, nxt)
                return outs, tuple(p[-2:] for p in arr)

            step = _jax.jit(_step) if not first else _jax.jit(
                lambda ps: _step(None, ps))
            self._step_cache[key] = step
        outs, self._tail = (step(planes) if first
                            else step(self._tail, planes))
        return outs

    def flush_batch(self) -> list:
        """Drain the final frame (next clamps to the last frame)."""
        if self._window:
            raise RuntimeError("this session is in streaming mode; "
                               "use flush()")
        if self._tail is None:
            return []
        prev = tuple(p[0:1] for p in self._tail)
        cur = tuple(p[1:2] for p in self._tail)
        self._tail = None
        return self._emit(prev, cur, cur)


@dataclass
class QualityMessage:
    """Upstream quality notification (the IQualityControl ``Notify`` payload,
    Source/renbase2.cpp:363-476): advises the supplier/decoder to degrade or
    improve.  ``kind`` is "famine" (the time is going elsewhere — supplier
    should cheapen) or "flood" (rendering dominates — we degrade);
    ``proportion`` is the per-mille rate request clamped to [500, 2000]
    (1000 = keep rate, <1000 = slow down / drop quality, >1000 = speed up);
    ``late_s`` is the lateness estimate including half the average render
    time."""

    kind: str
    proportion: int
    late_s: float
    timestamp_s: float


class QualityManager:
    """The base renderer's full quality-management loop
    (CBaseVideoRenderer2::ShouldDrawSampleNow + SendQuality,
    Source/renbase2.cpp:363-753, renbase2.h:46-148), in float seconds.

    Per frame, :meth:`should_draw` decides **draw now / wait until due /
    drop**, maintaining the same state machine as the reference:

     * an ~8 ms monitor-latency bias on presentation times;
     * ``earliness``: after a drop the next frame plays early, then slides
       gracefully back to normal timing (-12 %/frame);
     * ``wait_avg`` / ``frame_avg`` / ``render_avg`` EWMAs (period 4, the
       DirectShow AVGPERIOD) deciding whether dropping would even help;
     * the supplier-feedback channel: a famine/flood :class:`QualityMessage`
       per frame via ``quality_sink`` — return True from the sink to signal
       "supplier is handling quality" (frames are then tolerated up to 4
       durations late before dropping, and play very early after the
       supplier drops one).

    Drops and lateness flow into an attached :class:`~videorenderer.
    stats.Metrics` (drop counter + sync-offset accumulators -> stats OSD).
    """

    AVG_PERIOD = 4              # DirectShow AVGPERIOD
    MONITOR_BIAS_S = 0.008      # refresh-wait compensation (renbase2.cpp:500)

    def __init__(self, quality_sink: Callable | None = None,
                 metrics: "Metrics | None" = None):
        self.quality_sink = quality_sink
        self.metrics = metrics
        self.supplier_handling_quality = False
        self.last_quality: QualityMessage | None = None
        self.dropped = 0
        self.drawn = 0
        self.reset_streaming_times()

    def reset_streaming_times(self) -> None:
        """ResetStreamingTimes (Source/renbase2.cpp:61-86)."""
        self.last_draw = -1.001    # "ages ago": first frame always draws
        self.render_avg = 0.0
        self.render_last = 0.0
        self.frame_avg = -1.0      # <0 == unset
        self.duration = 0.0
        self.wait_avg = 0.0
        self.n_normal = 0          # -1 == just dropped a frame
        self.earliness = 0.0
        self._render_start = 0.0
        self._stamp_for_perf = 0.0

    # -- render-time measurement (OnRenderStart/End, renbase2.cpp:243-268) --

    def on_render_start(self, now: float | None = None) -> None:
        self._render_start = precise_tick() if now is None else now

    def on_render_end(self, now: float | None = None) -> None:
        """Fold the just-measured render time into ``render_avg`` unless it
        is a >32x spike (thread-interruption noise, renbase2.cpp:255-268)."""
        tr = (precise_tick() if now is None else now) - self._render_start
        p = self.AVG_PERIOD
        if tr < self.render_avg * 32 or tr < self.render_last * 32:
            self.render_avg = (tr + (p - 1) * self.render_avg) / p
        self.render_last = tr

    # -- supplier feedback (SendQuality, renbase2.cpp:363-476) ---------------

    def _send_quality(self, late: float, real_stream: float) -> bool:
        if self.frame_avg < 0 or self.frame_avg > 2 * self.render_avg:
            kind = "famine"       # time mostly spent outside rendering
        else:
            kind = "flood"        # rendering dominates
        proportion = 1000
        if self.frame_avg < 0:
            pass                  # not enough data — leave it alone
        elif late > 0:
            # catch up over the next second; don't go below half rate
            proportion = max(500, 1000 - int(late * 1000))
        elif self.wait_avg > 0.002 and late < -0.002:
            # consistently early: cautiously ask for more, aim at 2 ms wait
            if self.wait_avg >= self.frame_avg:
                proportion = 2000
            elif self.frame_avg + 0.002 > self.wait_avg:
                proportion = int(
                    1000 * (self.frame_avg
                            / (self.frame_avg + 0.002 - self.wait_avg)))
            else:
                proportion = 2000
            proportion = min(proportion, 2000)
        msg = QualityMessage(kind, proportion, late + self.render_avg / 2,
                             real_stream)
        self.last_quality = msg
        if self.quality_sink is not None:
            return bool(self.quality_sink(msg))
        return False

    def _record(self, accuracy: float, frame: float) -> None:
        """RecordFrameLateness analogue: feed the per-frame lateness into the
        sync-offset accumulators and graph (renbase2.cpp:185-202)."""
        self.drawn += 1
        if self.metrics is not None:
            self.metrics.render_stats.record_sync_offset(accuracy)
            self.metrics.sync_graph.add(accuracy)

    # -- the decision (ShouldDrawSampleNow, renbase2.cpp:489-753) ------------

    def should_draw(self, start: float, end: float, now: float,
                    discontinuity: bool = False) -> tuple[str, float]:
        """Decide the fate of a frame stamped [``start``, ``end``) with the
        stream clock at ``now`` (all seconds, any common epoch).  Returns
        ``(decision, adjusted_start)`` with decision one of ``"draw"``
        (render immediately), ``"wait"`` (render at ``adjusted_start`` —
        possibly pulled early by the earliness ramp), ``"drop"``.
        ``discontinuity``: the supplier flagged this sample as following a
        gap (it dropped one)."""
        p = self.AVG_PERIOD
        if start >= self.MONITOR_BIAS_S:
            start -= self.MONITOR_BIAS_S
            end -= self.MONITOR_BIAS_S
        self._stamp_for_perf = start
        true_late = now - start
        late = true_late
        self.supplier_handling_quality = self._send_quality(late, now)
        duration = end - start

        # major frame-rate change: reset the average to the new rate
        t = self.duration / 32
        if duration > self.duration + t or duration < self.duration - t:
            self.frame_avg = duration
            self.duration = duration

        just_dropped = ((self.supplier_handling_quality and discontinuity)
                        or self.n_normal == -1)

        # earliness slide (slow -> fast machine mode, renbase2.cpp:567-575)
        if late > 0:
            self.earliness = 0.0
        elif late >= self.earliness or just_dropped:
            self.earliness = late
        else:
            self.earliness -= self.earliness / 8

        # prospective wait average (never mix in a negative wait)
        wait_avg_new = (max(-late, 0.0) + self.wait_avg * (p - 1)) / p
        frame = min(now - self.last_draw, 1.0)

        draw = (
            # dropping won't help: render time is a small fraction of the
            # inter-frame time
            3 * self.render_avg <= self.frame_avg
            # or the frame is still timely enough (4 durations of grace when
            # the supplier handles quality)
            or (late <= duration * 4 if self.supplier_handling_quality
                else late * 2 < duration)
            # or we usually wait >8 ms — this lateness is just a glitch
            or self.wait_avg > 0.008
            # or nothing has been drawn for over a second (don't look hung)
            or (now - self.last_draw) > 1.0)
        if not draw:
            # drop it; draw the next one early
            self.wait_avg = wait_avg_new
            self.n_normal = -1
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.draw_stats.drops += 1
            return ("drop", start)

        # slow-machine mode: play it AT ONCE if we are playing catch-up or
        # running below the true frame rate (but never when grossly early)
        play_asap = just_dropped or (
            self.frame_avg > duration + duration / 16
            and late > -duration * 10)
        if late < -0.9:
            play_asap = False

        if play_asap:
            self.n_normal = 0
            # zero wait: don't let supplier-drop oscillation fake spare time
            self.wait_avg = self.wait_avg * (p - 1) / p
            self.frame_avg = (frame + self.frame_avg * (p - 1)) / p
            self._record(true_late, frame)
            self.last_draw = now
            if self.earliness > late:
                self.earliness = late
            return ("draw", start)

        self.n_normal += 1
        # exiting slow-machine mode leaves a long real gap; record the ideal
        # rate instead so we don't bounce straight back in
        self.frame_avg = duration
        # play it early by the (negative) earliness, at most one frame
        start += max(self.earliness, -self.frame_avg)
        delay = -true_late
        self.wait_avg = wait_avg_new
        if delay > 0:     # we are going to wait
            frame = start - self.last_draw
            self.last_draw = start
            self._record(start - self._stamp_for_perf, frame)
            return ("wait", start)
        self.last_draw = now
        self._record(true_late, frame)
        return ("draw", start)


class PresentClock:
    """Real-time presentation pacing: decides drop/render per frame like the
    base renderer's quality management (renbase2.h:46-148) and sleeps to the
    stream time (SyncFrameToStreamTime, Source/VideoProcessor.cpp:258-271).

    :meth:`schedule` is the full quality-managed path (earliness ramp,
    famine/flood supplier feedback via ``quality_sink``, drop accounting into
    ``metrics``); :meth:`should_drop` is the simple drop-if-late rule kept
    for callers that manage their own waiting."""

    def __init__(self, fps: float, adjust_present_time: bool = True,
                 quality_sink: Callable | None = None,
                 metrics: "Metrics | None" = None):
        self.frame_duration = 1.0 / fps
        self.adjust = adjust_present_time
        self.start: float | None = None
        self.dropped = 0
        self.rendered = 0
        self.quality = QualityManager(quality_sink=quality_sink,
                                      metrics=metrics)

    def schedule(self, frame_index: int, discontinuity: bool = False) -> bool:
        """Quality-managed scheduling of frame ``frame_index``: runs the
        renbase2 decision, sleeps when the verdict is "wait" (honoring the
        earliness pull-forward), and returns True when the frame should be
        rendered (False == dropped).  Call ``quality.on_render_start/end``
        around the actual render to feed the degrade decision."""
        if self.start is None:
            self.start = precise_tick()
        due = frame_index * self.frame_duration
        now = precise_tick() - self.start
        decision, adj_start = self.quality.should_draw(
            due, due + self.frame_duration, now, discontinuity)
        if decision == "drop":
            self.dropped += 1
            return False
        if decision == "wait" and self.adjust:
            delay = adj_start - (precise_tick() - self.start)
            if delay > 0:
                time.sleep(delay)
        self.rendered += 1
        return True

    def should_drop(self, frame_index: int) -> bool:
        """True if the frame's presentation time has already passed by more
        than one frame duration (drop-if-late,
        Source/DX11VideoProcessor.cpp:2176-2197)."""
        if self.start is None:
            self.start = precise_tick()
            return False
        due = self.start + frame_index * self.frame_duration
        late = precise_tick() - due
        if late > self.frame_duration:
            self.dropped += 1
            return True
        return False

    def wait_for(self, frame_index: int) -> float:
        """Sleep until the frame is due; returns the sync offset (s)."""
        if self.start is None:
            self.start = precise_tick()
        due = self.start + frame_index * self.frame_duration
        now = precise_tick()
        if self.adjust and due > now:
            time.sleep(due - now)
        self.rendered += 1
        return precise_tick() - due
