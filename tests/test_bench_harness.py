"""Bench-harness hygiene: the PSNR gate is only honest if the cached
float64 references always match the timed inputs.

Round-3 regression: a single sequential rng made frame 0's chroma depend
on the TIMING BATCH SIZE, so retuning a config's batch (c7/c8 8->32)
silently invalidated the cached references — the gate then failed at
~5-10 dB against inputs the device never processed.  Frames must be
batch-invariant, and the reference cache must self-invalidate when the
input spec changes.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench_common as bc
from videorenderer import ColorFormat


def test_make_planes_frames_batch_invariant():
    for fmt in (ColorFormat.NV12, ColorFormat.P010):
        small = bc.make_planes(fmt, 64, 32, 2, seed=0)
        large = bc.make_planes(fmt, 64, 32, 7, seed=0)
        for ps, pl_ in zip(small, large):
            np.testing.assert_array_equal(ps[0], pl_[0])
            np.testing.assert_array_equal(ps[1], pl_[1])


def test_make_planes_planes_decorrelated():
    y, u, v = bc.make_planes(ColorFormat.NV12, 64, 64, 1, seed=0)
    assert not np.array_equal(u, v)


def test_ref_spec_tracks_format_and_size_not_batch():
    spec = bc.ref_spec("c8")
    assert spec["fmt"] == "P010" and spec["w"] == 3840 and spec["h"] == 2160
    assert "batch" not in spec
    assert spec["scheme"] == bc.RNG_SCHEME


def test_bench_stream_modes_and_gain():
    """run_modes measures all three feed modes on identical inputs and
    reports overlap_gain = serial_time / overlap_time (bench_stream.py
    measures whether run_clip actually overlaps)."""
    import jax
    import bench_stream

    fn = jax.jit(lambda planes: planes[0].astype(np.float32) * 2.0)
    batches = [tuple(np.full((2, 8, 16), s, np.uint8) for _ in range(3))
               for s in (1, 2, 3)]
    r = bench_stream.run_modes(fn, batches, jax.devices()[0])
    assert set(r) == {"device", "overlap", "serial", "overlap_gain"}
    assert all(v > 0 for v in r.values())
    # gain = t_serial / t_overlap == overlap_fps / serial_fps
    assert abs(r["overlap_gain"] - r["overlap"] / r["serial"]) \
        < 1e-6 * r["overlap_gain"] + 1e-9


def test_ensure_refs_invalidates_on_spec_change(tmp_path, monkeypatch):
    import bench_configs

    monkeypatch.setattr(bc, "REF_DIR", str(tmp_path))
    monkeypatch.setattr(bench_configs.bc, "REF_DIR", str(tmp_path))
    np.save(tmp_path / "c8.npy", np.zeros((3, 4, 4), np.float32))
    # no sidecar -> stale
    assert not bench_configs._ref_fresh("c8")
    with open(tmp_path / "c8.spec.json", "w") as f:
        json.dump(bc.ref_spec("c8"), f)
    assert bench_configs._ref_fresh("c8")
    # spec drift (e.g. the rng scheme changes again) -> stale
    with open(tmp_path / "c8.spec.json", "w") as f:
        json.dump(dict(bc.ref_spec("c8"), scheme=-1), f)
    assert not bench_configs._ref_fresh("c8")


def test_roofline_reads_bench_configs_lines(tmp_path, monkeypatch, capsys):
    """bench_roofline.py turns bench_configs.py's JSON lines into roofline
    rows (other lines skipped), naming the card and the peaks' source."""
    import bench_roofline
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "card": "NVIDIA H100 80GB HBM3, 400.00 W"}
    f = tmp_path / "configs.jsonl"
    f.write_text("warming up\n" + json.dumps({"note": "no rate"}) + "\n"
                 + json.dumps({"key": "c2", "fps_median": 594.02,
                               "device": dev}) + "\n")
    monkeypatch.setattr(sys, "argv", ["bench_roofline.py", str(f)])
    bench_roofline.main()
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1
    row = rows[0]
    assert row["card"] == dev["card"] and "700 W" in row["peaks"]
    assert row["bound"] == "compute"
    assert row["gflop_per_frame"] > 60      # the dense 4K -> 1080p maps
    flop_s = row["gflop_per_frame"] * 1e9 / 67e12
    assert row["roofline_share"] == pytest.approx(flop_s * 594.02)


def test_roofline_unknown_device_is_an_error():
    import bench_roofline
    with pytest.raises(KeyError):
        bench_roofline.roofline_row("c2", 100.0, "Some Other GPU")
