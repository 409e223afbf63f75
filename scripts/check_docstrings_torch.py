#!/usr/bin/env python
"""Docstring-coverage gate for the port's ``repro_torch.bpmf`` and ``repro_torch.serve`` surface.

The port's counterpart of ``scripts/check_docstrings.py``, over the same
modules (:data:`MODULES`, the reference's list with ``repro`` read as
``repro_torch``): it fails if any public symbol (module, class, function,
method or property) defined under a covered package lacks a docstring.
Inherited docstrings count (``inspect.getdoc`` follows the MRO); dunders
and names starting with an underscore are exempt. Run it directly or
through ``scripts/test_torch.sh``, which always runs it::

    PYTHONPATH=src python scripts/check_docstrings_torch.py
"""
from __future__ import annotations

import importlib
import inspect
import sys

MODULES = (
    "repro_torch.bpmf",
    "repro_torch.bpmf.engine",
    "repro_torch.bpmf.backends",
    "repro_torch.bpmf.config",
    "repro_torch.bpmf.datasets",
    "repro_torch.serve",
    "repro_torch.serve.artifact",
    "repro_torch.serve.predictor",
    "repro_torch.serve.schema",
    "repro_torch.serve.batcher",
    "repro_torch.serve.sharded_topk",
    "repro_torch.serve.server",
    "repro_torch.serve.client",
    "repro_torch.core.subset_merge",
)

# symbols defined under these packages are held to the bar; re-exports from
# elsewhere (numpy, torch, repro_torch.core) are not
PREFIXES = ("repro_torch.bpmf", "repro_torch.serve", "repro_torch.core.subset_merge")


def _public_members(obj) -> list[tuple[str, object]]:
    return [(name, member) for name, member in vars(obj).items() if not name.startswith("_")]


def _missing_in_class(cls, prefix: str) -> list[str]:
    missing = []
    for name, member in _public_members(cls):
        raw = inspect.unwrap(member) if callable(member) else member
        if isinstance(member, property):
            if not inspect.getdoc(member):
                missing.append(f"{prefix}.{name} (property)")
        elif inspect.isfunction(raw) or isinstance(member, (classmethod, staticmethod)):
            if not inspect.getdoc(getattr(cls, name)):
                missing.append(f"{prefix}.{name}()")
    return missing


def check(module_names=MODULES) -> list[str]:
    """Every fully qualified public symbol of ``module_names`` that has no docstring, sorted."""
    missing: list[str] = []
    for mod_name in module_names:
        mod = importlib.import_module(mod_name)
        if not inspect.getdoc(mod):
            missing.append(mod_name + " (module)")
        for name, member in _public_members(mod):
            qual = f"{mod_name}.{name}"
            if inspect.isclass(member) and member.__module__.startswith(PREFIXES):
                if not inspect.getdoc(member):
                    missing.append(qual + " (class)")
                missing.extend(_missing_in_class(member, qual))
            elif inspect.isfunction(member) and member.__module__.startswith(PREFIXES):
                if not inspect.getdoc(member):
                    missing.append(qual + "()")
    return sorted(set(missing))


def main() -> int:
    missing = check()
    if missing:
        print(f"docstring coverage FAILED: {len(missing)} public symbol(s) undocumented")
        for sym in missing:
            print(f"  - {sym}")
        return 1
    print("docstring coverage OK: all public repro_torch.bpmf/repro_torch.serve symbols documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
