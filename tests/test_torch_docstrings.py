"""The port's docstring gate (``scripts/check_docstrings_torch.py``).

It covers the modules of the reference's gate with ``repro`` read as
``repro_torch``, passes on the port, and names a public symbol that has no
docstring.
"""
import importlib.util
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_gate_covers_the_reference_modules():
    ref, port = _load("check_docstrings"), _load("check_docstrings_torch")
    assert port.MODULES == tuple(m.replace("repro.", "repro_torch.", 1) for m in ref.MODULES)
    assert port.PREFIXES == tuple(p.replace("repro.", "repro_torch.", 1) for p in ref.PREFIXES)


def test_every_public_symbol_of_the_port_is_documented():
    assert _load("check_docstrings_torch").check() == []


def test_the_gate_names_an_undocumented_symbol(monkeypatch):
    gate = _load("check_docstrings_torch")
    mod = types.ModuleType("repro_torch.serve.fake_undocumented")
    mod.__doc__ = "A module with one undocumented function."
    exec("def served(x):\n    return x\n\nclass Box:\n    def open(self):\n        pass\n", mod.__dict__)
    mod.served.__module__ = mod.Box.__module__ = mod.__name__
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert gate.check((mod.__name__,)) == [f"{mod.__name__}.Box (class)", f"{mod.__name__}.Box.open()",
                                            f"{mod.__name__}.served()"]


def test_the_gate_main_passes(capsys):
    assert _load("check_docstrings_torch").main() == 0
    assert "docstring coverage OK" in capsys.readouterr().out
