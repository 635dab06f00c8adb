"""The deprecated alias package beside ``videorenderer`` (the package's old
name) resolves every import to the very module objects of
``videorenderer``, and warns."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = sorted(
    n for n in os.listdir(ROOT) if n.startswith("videorenderer_")
    and os.path.isfile(os.path.join(ROOT, n, "__init__.py")))

_CHECK = """
import sys, warnings
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    import {alias}.pipeline as old
    from {alias}.ops.scale import RESIZE_PRECISION
import videorenderer, videorenderer.pipeline as new
from videorenderer.ops import scale
assert old is new and RESIZE_PRECISION is scale.RESIZE_PRECISION
assert new.__spec__.name == "videorenderer.pipeline", new.__spec__
assert sys.modules["{alias}"] is videorenderer
assert any(issubclass(w.category, DeprecationWarning) for w in caught)
"""


def test_alias_shares_modules():
    assert ALIASES
    for alias in ALIASES:
        subprocess.run([sys.executable, "-c", _CHECK.format(alias=alias)],
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       check=True, timeout=120)
