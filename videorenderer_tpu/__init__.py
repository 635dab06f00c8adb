"""Deprecated alias of :mod:`videorenderer`, the package's name since 0.4.

Importing this package, or any of its submodules, returns the module
objects of ``videorenderer`` themselves (one copy of each, so classes,
caches and registries are shared).  New code imports ``videorenderer``.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import videorenderer

_NEW = videorenderer.__name__
_OLD = __name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.x.y`` to the module ``videorenderer.x.y``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamps the alias spec on the shared module;
        # give it back its own
        module.__spec__ = module.__spec__.loader_state


warnings.warn(f"{_OLD} is deprecated; import {_NEW}", DeprecationWarning,
              stacklevel=2)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = videorenderer
