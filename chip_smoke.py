#!/usr/bin/env python
"""On-card smoke check: the renderer's main path runs on an NVIDIA GPU.

    python chip_smoke.py               # default phases, one card
    python chip_smoke.py --all-cells   # default phases + every other cell
    python chip_smoke.py --four-cards  # only the four-card paths

Default phases, each printing one JSON line:

 * device gate — exits non-zero, printing no result, unless
   ``jax.devices()[0]`` is a GPU (a CUDA plugin that fails to load leaves
   JAX on the CPU silently);
 * ``headline`` — 3840x2160 P010 HDR10 -> 1920x1080 RGB10 packed surface
   (Lanczos3, Hable tone map, ordered dither) through
   ``api.VideoRenderer`` (``open``, then ``process_frame`` for three frames)
   and ``runner.run_clip`` (three host-resident batches); frame 0 against
   ``bench.numpy_oracle`` (numpy float64) at >= 55 dB;
 * one ``cell`` per translated path, built by ``bench_common.build_plan`` at
   its real frame size, batch 2: c3 (Jinc2 phase geometry), c3rot (Jinc2
   low-rank, period 9), c5 (double-rate deinterlace through
   ``runner.DeinterlaceSession``), c8 (DoVi split-fused serving, per-scene
   curves), c7 (HDR10 serving, runtime scalars), c3sr (learned SuperRes).
   Each prints compile seconds, ``memory_analysis()``, the process's
   ``peak_bytes_in_use``, one smoke ms/frame beside the card's name and
   power limit, and PSNR against the float64 staged reference, which a
   child process computes on the CPU (``bench_oracle.py``; it never opens
   the card);
 * ``gpu_tests`` — the ``gpu``-marked tests, in this process (a second
   process could not open the card).

Precision and tolerances: the card computes in float32 with every resize,
chroma and low-rank Jinc2 product at ``Precision.HIGHEST`` (full float32,
no TF32); the learned nets compute in bfloat16 by design.  The references
are float64.  Gates: 55 dB PSNR on the quantized output (40 dB for the
learned rows, whose gap measures bf16 model numerics).  The four-card paths
must also agree with the one-card output (``_agreement``): >= 80 dB PSNR, no
value more than 4 codes apart, under 1e-4 of the values differing at all,
and no gathering of the differing values on the rows next to a shard seam.
Their per-card matmul shapes differ from the one-card ones, so float32 sums
may round in another order; a wrong shard, halo or sharding rule spoils
whole rows.  Each four-card phase also records the same comparison before
quantization, and where the differing values lie.

Any failed phase makes the exit code 1.  Only when every phase passed is
the last line ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CELLS = ["c3", "c3rot", "c5", "c8", "c7", "c3sr"]
CELL_BATCH = 2
HEADLINE_BATCH = 2
TIMED_CALLS = 3
TIMING_NOTE = ("smoke timing: one window of 3 device-synced dispatches "
               "after warm-up, not a benchmark")


def _keep_cpu_platform() -> None:
    """The gpu-marked tests compare the card with the same program compiled
    for the CPU, so a JAX_PLATFORMS that names only the GPU gains ``cpu``
    (the GPU stays first, so it stays the default device)."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


class Oracle:
    """float64 references from ``bench_oracle.py`` in a CPU-only child
    process, started first so it computes while the card compiles."""

    def __init__(self, keys):
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "bench_oracle.py"), *keys],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.log = None

    def ref(self, key):
        import numpy as np

        import bench_common as bc
        if self.log is None:
            self.log, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError("float64 oracle failed:\n"
                                   + self.log[-4000:])
        return np.load(os.path.join(HERE, bc.REF_DIR, f"{key}.npy"))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, k)) for k in dir(ma) if k.endswith("_in_bytes")}


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _smoke_ms(call, frames: int) -> float:
    import jax
    jax.block_until_ready(call())
    t0 = time.perf_counter()
    outs = [call() for _ in range(TIMED_CALLS)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) * 1e3 / (TIMED_CALLS * frames)


def _gate(name: str, psnr: float, bar: float) -> None:
    if not psnr >= bar:
        raise AssertionError(f"{name}: PSNR {psnr:.2f} dB below {bar} dB")


AGREEMENT_BAR = 80.0      # dB, four-card vs one-card output
MAX_CODE_DIFF = 4         # codes, any single value
MAX_DIFFERING = 1e-4      # share of the output values that differ at all
SEAM_BAND = 4             # output rows on each side of a shard boundary
DARK_CODE = 64            # "near black": one-card code below this


def _agreement(got, ref, lsb: float, seams=()) -> dict:
    """Four-card vs one-card outputs as float codes, (..., 3, H, W).

    They agree when all of these hold: PSNR between them >= AGREEMENT_BAR;
    no value more than MAX_CODE_DIFF codes apart; under MAX_DIFFERING of the
    values differ; and the rows within SEAM_BAND of a shard boundary
    (``seams``, output rows) hold at most four times their share of the
    differing values, plus four.  A wrong halo or shard offset spoils seam
    rows, which the last two tests see even where PSNR stays high.  The
    record also says where the differing values lie: their positions, and
    how many of them are near black on the one-card output."""
    import numpy as np

    import bench_common as bc
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    codes = np.rint(np.abs(got - ref) / lsb)
    diff = codes > 0
    pos = np.argwhere(diff)
    ref_codes = np.rint(ref[diff] / lsb)
    rec = {"psnr_db_vs_one_card": bc.psnr_db(got, ref),
           "max_code_diff": int(codes.max()),
           "differing_values": int(diff.sum()),
           "differing_fraction": float(diff.mean()),
           "differing_near_black": int((ref_codes < DARK_CODE).sum()),
           "one_card_codes_at_differing": (
               [int(ref_codes.min()), int(np.median(ref_codes)),
                int(ref_codes.max())] if len(pos) else []),
           "differing_at": pos[:12].tolist()}
    bad = []
    if not rec["psnr_db_vs_one_card"] >= AGREEMENT_BAR:
        bad.append(f"PSNR below {AGREEMENT_BAR} dB")
    if rec["max_code_diff"] > MAX_CODE_DIFF:
        bad.append(f"a value more than {MAX_CODE_DIFF} codes apart")
    if not rec["differing_fraction"] < MAX_DIFFERING:
        bad.append(f"{MAX_DIFFERING} or more of the values differ")
    if seams:
        h = got.shape[-2]
        band = np.zeros(h, bool)
        for s in seams:
            band[max(s - SEAM_BAND, 0):s + SEAM_BAND] = True
        rec["differing_on_seam_rows"] = int(band[pos[:, -2]].sum())
        rec["seam_rows_allowed"] = 4 + 4 * len(pos) * float(band.mean())
        if rec["differing_on_seam_rows"] > rec["seam_rows_allowed"]:
            bad.append("differing values gather on the shard seams")
    rec["failures"] = bad
    return rec


class PhaseFailed(AssertionError):
    """A failed check whose phase record is still printed in full."""

    def __init__(self, msg: str, record: dict):
        super().__init__(msg)
        self.record = record


def _require_agreement(result: dict) -> dict:
    bad = result["vs_one_card"]["failures"]
    if bad:
        raise PhaseFailed("four-card output disagrees with one card: "
                          + "; ".join(bad), result)
    return result


def _unquantized(plan) -> dict:
    """The plan with dither and quantization off (``chain``), and that again
    without the HDR->SDR transfer chain (``linear_part``: chroma, matrix and
    resample only), to show where a four-card gap starts and grows."""
    import dataclasses
    raw = dataclasses.replace(plan, dither_bits=None)
    return {"chain": raw,
            "linear_part": dataclasses.replace(raw, convert_to_sdr=False)}


def _float_gap(got, ref, seams=()) -> dict:
    """The same comparison before quantization (dither off): the largest gap
    between the four-card and one-card floats, where it is and the one-card
    value there, and with ``seams`` the largest gap on seam rows and off
    them.  Recorded, not gated."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    at = np.unravel_index(int(np.argmax(d)), d.shape)
    rec = {"max_gap": float(d[at]), "max_gap_at": [int(i) for i in at],
           "one_card_value_there": float(ref[at]),
           "values_gap_over_1e-6": int((d > 1e-6).sum())}
    if seams:
        band = np.zeros(d.shape[-2], bool)
        for s in seams:
            band[max(s - SEAM_BAND, 0):s + SEAM_BAND] = True
        rec["max_gap_seam_rows"] = float(d[..., band, :].max())
        rec["max_gap_other_rows"] = float(d[..., ~band, :].max())
    return rec


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def headline(dev, card, oracle) -> dict:
    import jax
    import numpy as np

    import bench
    import bench_common as bc
    from videorenderer.api import VideoRenderer
    from videorenderer.runner import run_clip

    st, src, dst = bench.headline_settings()
    vr = VideoRenderer(st, pack_surface=True)
    vr.open(src, dst)
    host = [bench.make_frames(HEADLINE_BATCH, seed=k) for k in range(3)]
    t0 = time.perf_counter()
    first = vr.process_frame(tuple(p[0] for p in host[0]))
    first.block_until_ready()
    compile_s = time.perf_counter() - t0
    for b, i in ((0, 1), (1, 0)):
        vr.process_frame(tuple(p[i] for p in host[b])).block_until_ready()
    assert first.shape == (bench.OH, bench.OW) and first.dtype == np.int32

    run_clip(vr._fn, host)                      # compiles the batch shape
    clip = run_clip(vr._fn, host)               # three host-resident batches
    assert clip.frames == 3 * HEADLINE_BATCH

    ref = bench.numpy_oracle(*(p[0] for p in host[0]))
    psnr_api = bc.psnr_db(bench.decode_rgb10(first), ref)
    psnr_clip = bc.psnr_db(bench.decode_rgb10(clip.outputs[0][0]), ref)
    _gate("VideoRenderer.process_frame", psnr_api, bc.DEFAULT_BAR)
    _gate("run_clip", psnr_clip, bc.DEFAULT_BAR)
    return {"chain": "3840x2160 P010 PQ -> 1920x1080 RGB10 packed, "
                     "Lanczos3 + Hable + ordered dither",
            "compile_s": compile_s, "psnr_db_process_frame": psnr_api,
            "psnr_db_run_clip": psnr_clip,
            "run_clip_ms_per_frame": clip.seconds * 1e3 / clip.frames,
            "timing": "smoke timing: one host-fed run_clip of 3 batches "
                      "after warm-up, transfers included, not a benchmark",
            "card": card, "peak_bytes_in_use": _peak_bytes(dev)}


def _deint_cell(key, plan, planes):
    """c5/c5s: the double-rate session; frame 0's first field comes from
    the stream-start window (prev clamps to frame 0), as in the oracle."""
    import jax

    import bench_common as bc
    from videorenderer.pipeline import make_deint_fields_fn
    from videorenderer.runner import DeinterlaceSession

    if key == "c5s":
        from videorenderer.ops.overlay import blend_in_rect_packed
        rgb, alpha = bc.subtitle_overlay()
        post = jax.jit(lambda s: blend_in_rect_packed(
            s, rgb, alpha, x=bc.SUB_X, y=bc.SUB_Y, fmt="rgba8"))
    else:
        post = lambda s: s
    sess = DeinterlaceSession(plan, double_rate=True, pack_surface=True)
    t0 = time.perf_counter()
    fields = [post(o) for o in sess.push_batch(planes)]
    jax.block_until_ready(fields)
    compile_s = time.perf_counter() - t0
    compiled = jax.jit(make_deint_fields_fn(plan, pack_surface=True)).lower(
        planes, planes, planes).compile()
    ms = _smoke_ms(lambda: [post(o) for o in sess.push_batch(planes)],
                   CELL_BATCH)
    return fields[0][0], compile_s, compiled, ms


def cell(key, dev, card, oracle) -> dict:
    import jax
    import numpy as np

    import bench_common as bc

    plan = bc.build_plan(key)
    fmt, w, h, _ = bc.input_spec(key)
    planes = jax.device_put(bc.make_planes(fmt, w, h, CELL_BATCH, seed=0),
                            dev)
    if key in ("c5", "c5s"):
        out0, compile_s, compiled, ms = _deint_cell(key, plan, planes)
    else:
        fn = bc.cell_frame_fn(key, plan)
        rt = bc.cell_rt(key, 0)
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(planes, rt).compile()
        compile_s = time.perf_counter() - t0
        out0 = compiled(planes, rt)[0]
        ms = _smoke_ms(lambda: compiled(planes, rt), CELL_BATCH)
    got = bc.decode_output(np.asarray(out0), plan)
    ref = bc.reference_codes(key, plan, oracle.ref(key))
    if got.shape != ref.shape:
        raise AssertionError(f"{key}: output {got.shape} vs reference "
                             f"{ref.shape}")
    psnr = bc.psnr_db(got, ref)
    bar = bc.PSNR_BAR.get(key, bc.DEFAULT_BAR)
    _gate(key, psnr, bar)
    return {"cell": key, "name": bc.NAMES[key], "batch": CELL_BATCH,
            "compile_s": compile_s, "memory_analysis": _memory(compiled),
            "peak_bytes_in_use": _peak_bytes(dev),
            "smoke_ms_per_frame": ms, "timing": TIMING_NOTE, "card": card,
            "psnr_db": psnr, "psnr_bar_db": bar}


def gpu_tests(dev, card, oracle) -> dict:
    import pytest

    class Tally:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.passed and report.when == "call":
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    tally = Tally()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(HERE, "tests", "test_gpu_smoke.py")],
                     plugins=[tally])
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise AssertionError(f"gpu tests: exit {rc}, {tally.passed} passed, "
                             f"{tally.failed} failed, {tally.skipped} "
                             "skipped")
    return {"passed": tally.passed}


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def frame_parallel(dev, card, oracle) -> dict:
    """The headline chain data-parallel over 4 cards at batch 8, vs one
    card at batch 8 (gated) and vs the float64 oracle.  Recorded beside
    them: the one-card output at the per-card batch of 2, and the same
    comparison before quantization."""
    import jax
    import numpy as np

    import bench
    import bench_common as bc
    from videorenderer.parallel.mesh import jit_frame_parallel, make_mesh
    from videorenderer.pipeline import make_frame_fn, plan_pipeline

    plan = plan_pipeline(*bench.headline_settings())
    fn = make_frame_fn(plan, pack_surface=True)
    host = bench.make_frames(8, seed=0)
    mesh = make_mesh(4)
    dp = jit_frame_parallel(fn, mesh)
    t0 = time.perf_counter()
    out = dp(host)
    out.block_until_ready()
    compile_s = time.perf_counter() - t0
    assert len(out.sharding.device_set) == 4, out.sharding
    one_fn = jax.jit(fn)
    one = np.asarray(one_fn(jax.device_put(host, dev)))
    one_b2 = np.concatenate([np.asarray(one_fn(jax.device_put(
        tuple(p[i:i + 2] for p in host), dev))) for i in range(0, 8, 2)])
    out = np.asarray(out)
    got = np.stack([bench.decode_rgb10(x) for x in out])
    match = _agreement(got, np.stack([bench.decode_rgb10(x) for x in one]),
                       1 / 1023)
    # float32 sums in another order are the expected cause of any gap: the
    # four cards run the one-card program at batch 2, not batch 8
    same_shape = {"identical": bool(np.array_equal(out, one_b2)),
                  "one_card_batch8_vs_batch2_differing":
                      int((one != one_b2).sum())}
    floats = {}
    for name, p in _unquantized(plan).items():
        raw = make_frame_fn(p)
        floats[name] = _float_gap(jit_frame_parallel(raw, mesh)(host),
                                  jax.jit(raw)(jax.device_put(host, dev)))
    psnr = bc.psnr_db(got[0], bench.numpy_oracle(*(p[0] for p in host)))
    _gate("frame-parallel", psnr, bc.DEFAULT_BAR)
    return _require_agreement({
        "chain": "headline, batch 8 over 4 cards", "compile_s": compile_s,
        "vs_one_card": match, "vs_one_card_batch2": same_shape,
        "before_quantization": floats, "psnr_db": psnr,
        "smoke_ms_per_frame": _smoke_ms(lambda: dp(host), 8),
        "timing": TIMING_NOTE + "; host-fed", "card": card})


def spatial_c9(dev, card, oracle) -> dict:
    """c9 (8K P010 -> 4K) row-sharded over a flat 4-card mesh with halo
    ppermute, vs the one-card output (gated, seam rows included) and the
    float64 reference; the same comparison before quantization is
    recorded beside them."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import bench_common as bc
    from videorenderer.parallel.spatial import (make_spatial_frame_fn,
                                                pad_shard_planes_rows)

    plan = bc.build_plan("c9")
    fmt, w, h, _ = bc.input_spec("c9")
    host = bc.make_planes(fmt, w, h, 1, seed=0)
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    one_mesh = Mesh(np.array([dev]), ("spatial",))
    planes = pad_shard_planes_rows(plan, mesh, host)
    one_planes = jax.device_put(host, dev)

    def run(p, m, x):
        out = jax.jit(make_spatial_frame_fn(p, m))(x)
        return np.asarray(out)[0, :, :p.dst.height]

    fn = jax.jit(make_spatial_frame_fn(plan, mesh))
    t0 = time.perf_counter()
    out = fn(planes)
    out.block_until_ready()
    compile_s = time.perf_counter() - t0
    assert len(out.sharding.device_set) == 4, out.sharding
    got = np.asarray(out)[0, :, :plan.dst.height]
    one = run(plan, one_mesh, one_planes)
    rows = plan.dst.height // 4
    seams = [k * rows for k in (1, 2, 3)]
    match = _agreement(got, one, 1 / 1023, seams)
    floats = {}
    for name, p in _unquantized(plan).items():
        floats[name] = _float_gap(run(p, mesh, planes),
                                  run(p, one_mesh, one_planes), seams)
    psnr = bc.psnr_db(bc.decode_output(got, plan), oracle.ref("c9"))
    _gate("c9 spatial", psnr, bc.DEFAULT_BAR)
    return _require_agreement({
        "cell": "c9", "name": bc.NAMES["c9"] + ", 4-card row mesh",
        "compile_s": compile_s, "seam_rows": seams, "vs_one_card": match,
        "before_quantization": floats, "psnr_db": psnr,
        "smoke_ms_per_frame": _smoke_ms(lambda: fn(planes), 1),
        "timing": TIMING_NOTE, "card": card})


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--all-cells", action="store_true",
                      help="also run every other bench_common.ALL_KEYS cell")
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the four-card paths")
    args = ap.parse_args()

    _keep_cpu_platform()
    sys.path.insert(0, HERE)
    import jax

    import bench_common as bc
    from videorenderer.compile_cache import enable_compile_cache

    dev = bc.require_gpu()

    if args.four_cards:
        if len(jax.devices()) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 2
        keys = ["c9"]
        phases = [("frame_parallel", frame_parallel),
                  ("spatial_c9", spatial_c9)]
    else:
        keys = list(DEFAULT_CELLS)
        if args.all_cells:
            keys += [k for k in bc.ALL_KEYS if k not in keys]
        phases = ([("headline", headline)]
                  + [(f"cell_{k}", lambda d, c, o, k=k: cell(k, d, c, o))
                     for k in keys]
                  + [("gpu_tests", gpu_tests)])

    smi = bc.nvidia_smi()
    card = smi.splitlines()[0]
    print(smi)
    print(json.dumps({"jax": jax.__version__, "platform": dev.platform,
                      "kind": dev.device_kind, "count": len(jax.devices()),
                      "compile_cache": enable_compile_cache()}), flush=True)

    oracle = Oracle(keys)
    failed = []
    try:
        for name, phase in phases:
            t0 = time.perf_counter()
            try:
                rec = phase(dev, card, oracle)
            except Exception as e:  # report every phase, then exit 1
                traceback.print_exc()
                failed.append(name)
                rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:500],
                       **getattr(e, "record", {})}
            else:
                rec = {"ok": True, **rec}
            print(json.dumps({"phase": name, "seconds":
                              time.perf_counter() - t0, **rec}), flush=True)
    finally:
        oracle.stop()
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
