"""Subtitle subsystem tests (SubPic queue analogues)."""

import time

import numpy as np
import jax.numpy as jnp

from videorenderer.subtitles import (PushSubtitleBridge, SubPic,
                                         SubPicQueue, SubPicQueueNoThread,
                                         TextEvent, TextSubtitleProvider,
                                         composite)


def _provider():
    return TextSubtitleProvider([
        TextEvent(1.0, 3.0, "hello", x=4, y=2),
        TextEvent(2.0, 4.0, "world", x=4, y=20),
    ], size=12)


def test_provider_render_windows():
    p = _provider()
    assert p.render(0.5) == []
    assert len(p.render(1.5)) == 1
    assert len(p.render(2.5)) == 2
    assert p.next_change(0.0) == 1.0
    assert p.next_change(1.0) == 2.0
    assert p.next_change(4.0) is None


def test_nothread_queue_caching():
    q = SubPicQueueNoThread(_provider())
    pics = q.lookup(1.5)
    assert len(pics) == 1
    assert q.lookup(2.5) and len(q.lookup(2.5)) == 2
    q.invalidate()
    assert len(q.lookup(0.0)) == 0


def test_threaded_queue():
    q = SubPicQueue(_provider(), max_ahead=4)
    try:
        pics = q.lookup(1.5)
        assert len(pics) == 1 and pics[0].covers(1.5)
        pics = q.lookup(2.5)
        assert len(pics) == 2
        assert q.lookup(5.0) == []
    finally:
        q.stop()


def test_push_bridge():
    b = PushSubtitleBridge()
    sp = SubPic(rgb=np.ones((3, 2, 2), np.float32),
                alpha=np.ones((2, 2), np.float32), x=0, y=0,
                start=0.0, stop=10.0)
    b.deliver([sp])
    assert len(b.render(5.0)) == 1
    assert b.render(11.0) == []


def test_composite_on_frame():
    frame = jnp.zeros((3, 16, 16))
    sp = SubPic(rgb=np.ones((3, 4, 4), np.float32),
                alpha=np.full((4, 4), 0.5, np.float32), x=2, y=3,
                start=0.0, stop=1.0)
    out = np.asarray(composite(frame, [sp]))
    assert out[0, 3, 2] == 0.5
    assert out[0, 0, 0] == 0.0
