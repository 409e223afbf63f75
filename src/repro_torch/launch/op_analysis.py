"""Op-level cost model of one rank's step: flops, bytes, collectives and peak memory.

The counterpart of ``repro.launch.hlo_analysis``. The reference lowers and
compiles its step and reads the partitioned HLO text; the port's step is
eager, so :class:`OpCostModel` (a ``TorchDispatchMode``) watches the aten
ops the step dispatches, on real tensors or on the ``meta`` device, where
nothing is allocated and no card is needed. :func:`analyze` returns the
keys ``hlo_analysis.analyze`` returns.

* **Flops.** Matrix products and convolutions count 2 flops per
  multiply-add (``torch.utils.flop_counter``'s formulas, the reference's
  count of dots and convolutions). Elementwise flops are not counted, as
  the reference does not count them. The linear algebra that
  ``FlopCounterMode`` leaves out takes the reference's custom-call
  formulas: ``cholesky_ex`` K³/3 per matrix, ``solve_triangular`` K²·nrhs
  (K the triangle's order), and ``inv_ex`` 2·K³, the two K-column
  triangular solves the reference's ``jnp.linalg.inv`` lowers to (the
  reference does not count its LU factorisation, so neither does this).
  A hand-written kernel called on ``meta`` tensors charges its own work
  (:func:`charge_kernel`).
* **Bytes.** Every op that is not a view is charged the bytes of its
  tensor arguments, read, and of its outputs, written (element count ×
  element size of each tensor as the op sees it). The port is eager, so
  this is what the card moves; the reference charges only at fusion
  boundaries, where XLA's fused ops keep their intermediates on chip.
  Allocations (``empty``) move nothing.
* **Collectives.** A collective of :mod:`repro_torch.models.collectives` or
  of the BPMF ring on an abstract group records its op, the payload bytes
  (what ``collectives.STATS`` counts for the same call), its group's axes,
  size and whether its ranks share a node. Wire bytes use the reference's
  ring formulas (:func:`wire_bytes`).
* **Peak.** Peak live bytes follow storage lifetimes: every storage an op
  makes during the step lives until its last reference goes, on top of
  the arguments alive at entry. This stands in for XLA's
  ``memory_analysis``: ``argument_bytes``, ``output_bytes``,
  ``temp_bytes`` and ``alias_bytes`` (outputs that are argument storages,
  as the in-place AdamW update and caches are), with
  ``peak_bytes_est = argument + output + temp - alias``.

An op's site is ``file:function:line`` of the innermost frame of this
package that dispatched it, or ``backward:<node>`` for an autograd node's
own work (which on the card runs on the engine's thread, where no frame of
the step is on the stack), so a trace on ``meta`` and one on real tensors,
on the CPU or the card, name the same sites.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any, Iterable

import torch
import torch.utils.flop_counter as flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
NODE_SIZE = 8  # consecutive ranks in one node (eight cards joined by NVLink)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = {os.path.abspath(__file__), os.path.join(_PKG, "models", "collectives.py")}
_AUTOGRAD = os.path.dirname(os.path.abspath(torch.autograd.__file__))
_BACKWARD = "\0backward"
_ACTIVE: list["OpCostModel"] = []
_aten = torch.ops.aten
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.lift_fresh.default,
}


def _cholesky(A, *args, **kwargs) -> float:
    k = A.shape[-1]
    return A[..., 0, 0].numel() * k**3 / 3.0


def _solve_triangular(A, B, *args, **kwargs) -> float:
    k = A.shape[-1]
    return B[..., 0, 0].numel() * k * k * B.shape[-1]


def _inv(A, *args, **kwargs) -> float:
    k = A.shape[-1]
    return A[..., 0, 0].numel() * 2.0 * k**3


_LINALG = {
    _aten.linalg_cholesky_ex: _cholesky,
    _aten.linalg_solve_triangular: _solve_triangular,
    _aten.linalg_inv_ex: _inv,
}


def wire_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Bytes one device sends for a collective whose result is ``result_bytes``, ring algorithms.

    The reference's formulas (``hlo_analysis.HloCostModel._collective``):
    all-reduce 2(S-1)/S of the result, all-gather (S-1)/S of the gathered
    result, reduce-scatter (S-1) × the scattered result, all-to-all
    (S-1)/S, a permute its payload.
    """
    S = group_size
    if op == "collective-permute":
        return float(result_bytes)
    if S <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (S - 1) / S * result_bytes
    if op == "all-gather":
        return (S - 1) / S * result_bytes
    if op == "reduce-scatter":
        return float((S - 1) * result_bytes)
    if op == "all-to-all":
        return (S - 1) / S * result_bytes
    raise ValueError(f"unknown collective {op!r}; one of {COLLECTIVE_OPS}")


def result_bytes(op: str, payload_bytes: int, group_size: int) -> int:
    """The bytes of a collective's result, from the bytes each rank hands it."""
    if op == "all-gather":
        return payload_bytes * group_size
    if op == "reduce-scatter":
        return payload_bytes // group_size
    return payload_bytes


def node_local(members: Iterable[int]) -> bool:
    """Whether the ranks ``members`` all lie in one node of :data:`NODE_SIZE` consecutive ranks."""
    return len({m // NODE_SIZE for m in members}) == 1


def active() -> "OpCostModel | None":
    """The innermost cost model in use, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_collective(op: str, payload_bytes: int, axes: tuple, size: int, members: Iterable[int]) -> None:
    """Record one collective on an abstract group with the active cost model (none: nothing)."""
    model = active()
    if model is not None:
        model.collective(op, payload_bytes, axes, size, members)


def charge_kernel(name: str, flops: float, nbytes: float) -> None:
    """Charge a hand-written kernel's own work to the active cost model (none: nothing)."""
    model = active()
    if model is not None:
        model.charge(f"kernel:{name}", flops, nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a tensor without storage (a functional wrapper)
        return None


class OpCostModel(TorchDispatchMode):
    """Counts what the ops dispatched inside it cost; see the module docstring.

    Use as a context manager around one step; :meth:`arguments` registers
    the step's inputs first and :meth:`outputs` its results after, then
    :func:`analyze` and :meth:`memory` read the counts.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0  # ops that do flops or move bytes (views and allocations are not counted)
        self.flops_by_site: dict[str, float] = {}
        self.bytes_by_site: dict[str, float] = {}
        self.coll_by_site: dict[str, float] = {}
        self.coll_by_op: dict[str, dict] = {}
        self.coll_wire_bytes = 0.0
        self.collectives: list[dict] = []  # one record per call
        self._files: dict[str, str] = {}
        self._infos: dict = {}
        self._args: dict[int, int] = {}  # storage id -> bytes, the step's arguments
        self._made: dict[int, int] = {}  # storage id -> bytes, made during the step and alive
        self._live = 0
        self._peak = 0
        self._out: dict[int, int] = {}
        self._alias = 0

    # ---- the step's inputs and outputs -------------------------------------

    def arguments(self, *trees: Any) -> int:
        """Register the storages of the step's arguments (alive at entry); returns their bytes."""
        for t in _tensors(trees):
            st = _storage(t)
            if st is not None and st._cdata not in self._args:
                self._args[st._cdata] = st.nbytes()
        return self.argument_bytes

    def outputs(self, *trees: Any) -> None:
        """Register the storages of the step's results (an argument's storage is an alias)."""
        for t in _tensors(trees):
            st = _storage(t)
            if st is not None and st._cdata not in self._out:
                self._out[st._cdata] = st.nbytes()
                if st._cdata in self._args:
                    self._alias += st.nbytes()

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    # ---- what the ops cost -------------------------------------------------

    def _site(self) -> str:
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            name = self._files.get(code.co_filename)
            if name is None:
                path = os.path.abspath(code.co_filename)
                name = os.path.relpath(path, _PKG) if path.startswith(_PKG) and path not in _SKIP else ""
                if path.startswith(_AUTOGRAD):
                    name = _BACKWARD
                self._files[code.co_filename] = name
            if name == _BACKWARD:  # the engine's own work: on the card it runs on a thread of its own
                break
            if name:
                return f"{name}:{code.co_name}:{f.f_lineno}"
            f = f.f_back
        node = torch._C._current_autograd_node()
        return f"backward:{node.name()}" if node is not None else "(top)"

    def charge(self, site: str, flops: float, nbytes: float) -> None:
        """Add ``flops`` and ``nbytes`` at ``site``."""
        if flops:
            self.flops += flops
            self.flops_by_site[site] = self.flops_by_site.get(site, 0.0) + flops
        if nbytes:
            self.bytes += nbytes
            self.bytes_by_site[site] = self.bytes_by_site.get(site, 0.0) + nbytes

    def collective(self, op: str, payload_bytes: int, axes: tuple, size: int, members: Iterable[int]) -> None:
        """Record one collective: its op, payload, group and the reference's wire bytes."""
        rb = result_bytes(op, payload_bytes, size)
        wire = wire_bytes(op, rb, size)
        local = node_local(members)
        self.collectives.append({"op": op, "payload_bytes": payload_bytes, "result_bytes": rb, "wire_bytes": wire,
                                 "axes": list(axes), "size": size, "node_local": local})
        d = self.coll_by_op.setdefault(op, {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["payload_bytes"] += payload_bytes
        d["wire_bytes"] += wire
        self.coll_wire_bytes += wire
        site = f"{op}:{self._site()}"
        self.coll_by_site[site] = self.coll_by_site.get(site, 0.0) + wire

    def _track(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            st = _storage(t)
            if st is None:
                continue
            key = st._cdata
            if key in self._args or key in self._made:
                continue
            n = st.nbytes()
            self._made[key] = n
            self._live += n
            self._peak = max(self._peak, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._made.pop(key, 0)

    def _info(self, func) -> tuple:
        """(flop formula or None, whether the outputs alias an input, whether the op moves bytes, its name)."""
        info = self._infos.get(func)
        if info is None:
            packet = func._overloadpacket
            flop = flop_counter.flop_registry.get(packet)
            if flop is None and packet in _LINALG:
                rule = _LINALG[packet]
                flop = lambda *a, out_val=None, **k: rule(*a, **k)  # noqa: E731
            aliases = func.is_view or any(r.alias_info is not None for r in func._schema.returns)
            info = (flop, aliases, not func.is_view and func not in _NO_TRAFFIC, packet.__name__)
            self._infos[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flop, aliases, traffic, name = self._info(func)
        outs = _flat(out, [])
        flops = 0.0
        if flop is not None:  # a dtype argument (bmm's out_dtype overload) is no operand of the formula
            flops = float(flop(*[a for a in args if not isinstance(a, torch.dtype)], **kwargs, out_val=out))
        nbytes = 0
        if traffic:
            ins = _flat(args, [])
            if kwargs:
                _flat(tuple(kwargs.values()), ins)
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if flops or nbytes:
            self.ops += 1
            self.charge(f"{self._site()}:{name}", flops, nbytes)
        if not aliases:
            self._track(outs)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ---- results -----------------------------------------------------------

    def memory(self, argument_bytes: int | None = None) -> dict:
        """The ``memory_analysis`` counterpart: argument, output, temp and alias bytes, and the peak.

        ``argument_bytes`` stands in for the registered arguments' (the same
        step traced on a cut batch, charged the whole batch it takes).
        """
        arg = self.argument_bytes if argument_bytes is None else argument_bytes
        out = sum(self._out.values())
        peak = arg + self._peak
        temp = peak - arg - out + self._alias
        return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp, "alias_bytes": self._alias,
                "peak_bytes_est": arg + out + temp - self._alias}


def _flat(x: Any, out: list) -> list:
    """The tensors of an op's arguments or results (nested lists and tuples), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    return out


def _tensors(trees: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []

    def walk(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(trees)
    return out


def analyze(model: Any, top_sites: int = 0) -> dict:
    """``hlo_analysis.analyze``'s keys from a trace's counts (an :class:`OpCostModel`), plus the op count.

    ``top_sites``: the top sites by flops, by wire bytes and by bytes.
    """
    out = {
        "flops": model.flops,
        "bytes": model.bytes,
        "collective_wire_bytes": model.coll_wire_bytes,
        "collectives_by_op": model.coll_by_op,
        "ops": model.ops,
    }
    if top_sites:
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top_sites]  # noqa: E731
        out["top_flop_sites"] = top(model.flops_by_site)
        out["top_coll_sites"] = top(model.coll_by_site)
        out["top_byte_sites"] = top(model.bytes_by_site)
    return out
