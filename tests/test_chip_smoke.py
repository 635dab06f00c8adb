"""chip_smoke.py refuses to report without a GPU: on the CPU, and as a
lone file without the rest of the repository, it exits non-zero and prints
no result line.  Its four-card agreement check passes scattered rounding
gaps and fails seam, size and count faults."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return False
        except (ValueError, AttributeError):
            pass
    return True


def test_refuses_cpu():
    r = _run(ROOT)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert _no_result(r.stdout)


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert _no_result(r.stdout)


# -- the four-card agreement check, on synthetic outputs --------------------

def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _frame(seed=0, h=216, w=384):
    """(3, h, w) float codes of a 10-bit surface."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1024, (3, h, w)) / 1023.0


SEAMS = [54, 108, 162]


def _spoil(kind):
    ref = _frame()
    got = ref.copy()
    if kind == "scattered":            # isolated values a few codes apart
        rng = np.random.default_rng(1)
        for _ in range(5):
            c, r, x = rng.integers(3), rng.integers(216), rng.integers(384)
            got[c, r, x] += 3 / 1023
    elif kind == "seam_row":           # a halo error along part of a seam row
        got[0, 108, :20] += 2 / 1023
    elif kind == "five_codes":
        got[1, 10, 10] += 5 / 1023
    elif kind == "many":               # too many values off by one code
        got[:, ::8, ::8] += 1 / 1023
    return got, ref


@pytest.mark.parametrize("kind,failure", [
    ("identical", None),
    ("scattered", None),
    ("seam_row", "gather on the shard seams"),
    ("five_codes", "more than 4 codes apart"),
    ("many", "of the values differ"),
])
def test_agreement(kind, failure):
    got, ref = _spoil(kind)
    rec = _smoke()._agreement(got, ref, 1 / 1023, SEAMS)
    if failure is None:
        assert rec["failures"] == []
    else:
        assert any(failure in f for f in rec["failures"]), rec["failures"]
    assert rec["differing_values"] == int((np.rint(
        np.abs(got - ref) * 1023) > 0).sum())


def test_agreement_seam_row_passes_psnr():
    """A seam error that PSNR alone lets through."""
    got, ref = _spoil("seam_row")
    rec = _smoke()._agreement(got, ref, 1 / 1023, SEAMS)
    assert rec["psnr_db_vs_one_card"] >= _smoke().AGREEMENT_BAR
    assert rec["differing_on_seam_rows"] == 20


def test_require_agreement_keeps_the_record():
    got, ref = _spoil("five_codes")
    result = {"vs_one_card": _smoke()._agreement(got, ref, 1 / 1023)}
    with pytest.raises(AssertionError) as e:
        _smoke()._require_agreement(result)
    assert e.value.record is result


def test_float_gap_locates_the_largest_gap():
    ref = _frame()
    got = ref.copy()
    got[2, 109, 7] += 1e-3
    rec = _smoke()._float_gap(got, ref, SEAMS)
    assert rec["max_gap_at"] == [2, 109, 7]
    assert rec["max_gap_seam_rows"] == pytest.approx(1e-3)
    assert rec["max_gap_other_rows"] == 0.0
