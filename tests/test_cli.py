"""CLI coverage via main(argv) (no subprocess)."""

import numpy as np
import pytest

from videorenderer.cli import main


def _write_nv12(path, w, h, frames=2, seed=0):
    rng = np.random.default_rng(seed)
    bufs = []
    for _ in range(frames):
        y = rng.integers(16, 236, (h, w), np.uint8)
        u = rng.integers(16, 241, (h // 2, w // 2), np.uint8)
        v = rng.integers(16, 241, (h // 2, w // 2), np.uint8)
        uv = np.stack([u, v], -1).reshape(h // 2, w)
        bufs.append(y.tobytes() + uv.tobytes())
    path.write_bytes(b"".join(bufs))


def test_cli_process(tmp_path, capsys):
    clip = tmp_path / "clip.nv12"
    _write_nv12(clip, 32, 16)
    out = tmp_path / "out.rgb"
    rc = main(["process", str(clip), "--format", "NV12", "--size", "32x16",
               "--out", str(out), "--out-size", "64x32", "--matrix", "BT_709"])
    assert rc == 0
    assert out.stat().st_size == 2 * 64 * 32 * 3


def test_cli_process_rgb10(tmp_path):
    clip = tmp_path / "clip.nv12"
    _write_nv12(clip, 32, 16)
    out = tmp_path / "out.r10"
    rc = main(["process", str(clip), "--format", "NV12", "--size", "32x16",
               "--out", str(out), "--out-bits", "10"])
    assert rc == 0
    assert out.stat().st_size == 2 * 32 * 16 * 4  # packed dwords


def test_cli_bad_format(tmp_path):
    clip = tmp_path / "clip.nv12"
    _write_nv12(clip, 32, 16)
    with pytest.raises(SystemExit):
        main(["process", str(clip), "--format", "NOPE", "--size", "32x16",
              "--out", str(tmp_path / "x.rgb")])


def test_cli_missing_file(tmp_path):
    rc = main(["process", str(tmp_path / "nothere.nv12"), "--format", "NV12",
               "--size", "32x16", "--out", str(tmp_path / "x.rgb")])
    assert rc == 2


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "videorenderer" in out


def test_cli_settings_roundtrip(tmp_path, capsys):
    f = tmp_path / "s.json"
    assert main(["settings", "--file", str(f), "--set", "upscaling=4"]) == 0
    capsys.readouterr()
    assert main(["settings", "--file", str(f)]) == 0
    import json
    d = json.loads(capsys.readouterr().out)
    assert d["upscaling"] == 4


def test_cli_deinterlace_and_srt(tmp_path):
    clip = tmp_path / "clip.nv12"
    _write_nv12(clip, 32, 16, frames=3)
    out = tmp_path / "deint.rgb"
    rc = main(["process", str(clip), "--format", "NV12", "--size", "32x16",
               "--out", str(out), "--deinterlace", "double", "--no-dither"])
    assert rc == 0
    assert out.stat().st_size == 6 * 32 * 16 * 3  # 3 frames -> 6 fields

    srt = tmp_path / "s.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:10,000\nHI\n")
    out2 = tmp_path / "sub.rgb"
    rc = main(["process", str(clip), "--format", "NV12", "--size", "32x16",
               "--out", str(out2), "--srt", str(srt), "--no-dither"])
    assert rc == 0
    assert out2.stat().st_size == 3 * 32 * 16 * 3


def test_cli_y4m(tmp_path):
    from videorenderer.io.y4m import Y4MSource, write_y4m
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(2):
        frames.append((rng.integers(16, 236, (16, 32), np.uint8),
                       rng.integers(16, 241, (8, 16), np.uint8),
                       rng.integers(16, 241, (8, 16), np.uint8)))
    p = tmp_path / "clip.y4m"
    write_y4m(str(p), frames, 32, 16, fps=(30, 1))
    src = Y4MSource(str(p))
    assert (src.width, src.height, len(src)) == (32, 16, 2)
    assert src.fps == 30.0
    got = list(src)
    np.testing.assert_array_equal(got[0].planes[0], frames[0][0])
    batch = src.read_batch(1, 1)
    np.testing.assert_array_equal(batch[0][0], frames[1][0])

    out = tmp_path / "out.rgb"
    rc = main(["process", str(p), "--out", str(out), "--out-size", "64x32"])
    assert rc == 0
    assert out.stat().st_size == 2 * 64 * 32 * 3
