"""Image export + SRT parsing tests."""

import numpy as np

from videorenderer.io.image import save_bmp, save_image
from videorenderer.io.srt import parse_srt


def test_bmp_roundtrip(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    p = tmp_path / "x.bmp"
    save_bmp(str(p), rgb)
    from PIL import Image
    back = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(back, rgb)


def test_save_png(tmp_path):
    rgb = np.zeros((4, 4, 3), np.float32)
    rgb[..., 0] = 1.0
    p = tmp_path / "y.png"
    save_image(str(p), rgb)
    from PIL import Image
    back = np.asarray(Image.open(p))
    assert back[0, 0, 0] == 255 and back[0, 0, 1] == 0


def test_parse_srt():
    text = """1
00:00:01,000 --> 00:00:03,500
Hello <i>world</i>

2
00:01:00,250 --> 00:01:02,000
Second line
{with override}
"""
    evs = parse_srt(text)
    assert len(evs) == 2
    assert evs[0].start == 1.0 and evs[0].stop == 3.5
    assert evs[0].text == "Hello world"
    assert evs[1].start == 60.25
    assert "override" not in evs[1].text


def test_parse_srt_no_index_and_dot_ms():
    evs = parse_srt("00:00:00.500 --> 00:00:01.000\nhi")
    assert len(evs) == 1 and evs[0].start == 0.5


def test_y4m_frame_params(tmp_path):
    """YUV4MPEG2 frame markers may carry parameters ("FRAME Ixxx\\n"); the
    reader measures the marker length instead of assuming 6 bytes."""
    from videorenderer.io.y4m import Y4MSource
    w, h = 16, 8
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, (h, w), np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), np.uint8))
              for _ in range(3)]
    path = tmp_path / "p.y4m"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420mpeg2\n".encode())
        for planes in frames:
            f.write(b"FRAME Ip\n")  # frame-level parameter
            for p in planes:
                f.write(p.tobytes())
    srcf = Y4MSource(str(path))
    assert len(srcf) == 3
    got = list(srcf)
    assert len(got) == 3
    np.testing.assert_array_equal(got[2].planes[0], frames[2][0])
    batch = srcf.read_batch(1, 2)
    np.testing.assert_array_equal(batch[0][0], frames[1][0])
    np.testing.assert_array_equal(batch[2][1], frames[2][2])
