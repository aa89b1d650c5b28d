# Dynamic module loading for pipeline element deployment.
# (capability parity: aiko_services/utilities/importer.py:24-38 — load by
# dotted module name or filesystem path, with a cache)
#
# The port's own copy of aiko_services_tpu/utils/importer.py.

from __future__ import annotations

import importlib
import importlib.util
import os
import sys

__all__ = ["load_module", "load_class"]

_cache: dict[str, object] = {}


def load_module(name_or_path: str):
    """Load a module by dotted name ("pkg.mod") or file path ("/x/mod.py")."""
    if name_or_path in _cache:
        return _cache[name_or_path]
    if name_or_path.endswith(".py") or os.path.sep in name_or_path:
        path = os.path.abspath(name_or_path)
        mod_name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load module from {path}")
        module = importlib.util.module_from_spec(spec)
        sys.modules.setdefault(mod_name, module)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(name_or_path)
    _cache[name_or_path] = module
    return module


def load_class(module_name: str, class_name: str):
    module = load_module(module_name)
    try:
        return getattr(module, class_name)
    except AttributeError:
        raise ImportError(
            f"module {module_name!r} has no class {class_name!r}") from None
