"""CLI training commands end-to-end at toy scale: both trainers produce a
loadable checkpoint that `process` consumes.  Keeps the training surface
exercised in CI without real training time."""

import json
import os

import numpy as np

from videorenderer.cli import main


def _mk_clip(path, w=32, h=16):
    y = np.full((h, w), 126, np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = np.full((h // 2, w // 2), 128, np.uint8)
    uv = np.stack([u, v], -1).reshape(h // 2, w)
    with open(path, "wb") as f:
        f.write(y.tobytes() + uv.tobytes())


def test_train_superres_cli_roundtrip(tmp_path, capsys):
    ckpt = str(tmp_path / "sr.npz")
    rc = main(["train-superres", "--out", ckpt, "--steps", "2",
               "--frames", "4", "--patch", "32", "--batch", "2"])
    assert rc == 0 and os.path.exists(ckpt)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])

    clip = str(tmp_path / "clip.nv12")
    _mk_clip(clip)
    dst = str(tmp_path / "out.rgb")
    rc = main(["process", clip, "--format", "NV12", "--size", "32x16",
               "--out", dst, "--out-size", "64x32", "--batch", "1",
               "--superres", "P1080", "--superres-weights", ckpt])
    assert rc == 0
    a = np.frombuffer(open(dst, "rb").read(), np.uint8)
    assert a.size == 64 * 32 * 3 and np.isfinite(a.astype(np.float32)).all()


def test_train_videohdr_cli_roundtrip(tmp_path, capsys):
    ckpt = str(tmp_path / "vh.npz")
    rc = main(["train-videohdr", "--out", ckpt, "--steps", "2",
               "--frames", "4", "--patch", "32", "--batch", "2"])
    assert rc == 0 and os.path.exists(ckpt)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["val_pq_psnr_net_db"])

    clip = str(tmp_path / "clip.nv12")
    _mk_clip(clip)
    dst = str(tmp_path / "out.rgb")
    rc = main(["process", clip, "--format", "NV12", "--size", "32x16",
               "--out", dst, "--out-size", "32x16", "--batch", "1",
               "--videohdr-weights", ckpt])
    assert rc == 0
    a = np.frombuffer(open(dst, "rb").read(), np.uint8)
    assert a.size == 32 * 16 * 3
