"""Counter-based random numbers: JAX's threefry2x32, as one CUDA kernel per draw or as torch integer ops.

The sampler keys every draw by ``fold_in`` on a threefry2x32 key, so the
noise of an item depends only on (run key, sweep, item id) and never on the
layout of the arrays (DESIGN.md §1). This module reproduces the bit layout
of ``jax.random`` with ``jax_threefry_partitionable=True``, so a run of this
package draws the same normals as a run of the JAX package from the same
key:

* a key is an int64 tensor ``[..., 2]`` holding the two uint32 words of
  ``jax.random.key_data``; leading dimensions batch independent keys;
* ``key(seed)`` is ``[0, seed mod 2**32]``;
* ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
* ``split(k, n)[i]`` is ``threefry(k, (0, i))``;
* ``random_bits(k, shape)`` hashes the flat counter ``i`` as ``(i >> 32,
  i & 0xffffffff)`` and xors the two output words;
* ``uniform`` keeps the top 23 bits as a mantissa in ``[1, 2)`` and
  subtracts one; ``normal`` is ``sqrt(2) * erfinv(u)`` on
  ``u ~ U[nextafter(-1, 0), 1)``, with XLA's single-precision ``erfinv``
  polynomial.

Each of ``fold_in``, ``split``, ``random_bits``, ``uniform`` and ``normal``
takes one of two paths, by the key's device. On a CUDA tensor it launches
the hand-written kernel of ``kernels/csrc/bpmf_prng.cu`` once: the hash in
uint32 registers and the float work after it, writing only the output.
On a CPU or ``meta`` tensor it runs its plain version (``fold_in_plain``
and so on): the uint32 words held in int64 and masked to 32 bits after
every add and shift, about 170 elementwise ops a hash. There is no other
route: a CUDA tensor never reaches the plain ops unless a caller names
them (the card tests do, as the kernel's yardstick), and a CPU or ``meta``
tensor never reaches the kernel. On the card the two give the same bits:
the kernel rounds each float operation where the plain ops do (see the
source's note). ``LAUNCHES`` counts the kernel's launches (a captured
sweep's at each replay, as ``core/sweep_graph.py`` counts the Gram
kernels') and ``PLAIN_CALLS`` the plain versions' calls (one per draw), so
a run can show which path drew.

``gamma`` is this package's own Marsaglia–Tsang sampler on these bits. It
is deterministic in the key, but it is not ``jax.random.gamma`` bit for
bit: that is a rejection sampler with its own key schedule. It is the one
draw that the parity tests replace with JAX's (they monkeypatch this
module's ``gamma``), which is why callers reach it as ``prng.gamma``. Its
float logic is torch ops on either device; its draws take the paths above.

Nothing here reads a tensor back to the host or builds a device tensor
from host data: integer arguments enter the hash as Python ints (the
kernel's scalar counter), and the float constants are Python floats
(exact in float32, and only multiplied, added or compared, never divided
by), so every draw can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.build import load_library

LAUNCHES = 0
PLAIN_CALLS = 0

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# Giles' single-precision erfinv, as XLA expands erf_inv for float32
_ERFINV_SMALL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_LARGE = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
# candidates drawn per entry and round of the gamma rejection loop: at
# shape >= 1 a candidate is accepted with probability > 0.95, so one round
# almost always settles every entry
_GAMMA_CANDIDATES = 8
# rounds of the gamma loop, all of them always drawn (see ``gamma``)
GAMMA_ROUNDS = 2
# the float32 constants of ``normal``: nextafter(-1, 0) and sqrt(2)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))
# the kernel's output kinds (bpmf_prng.cu's enum Kind)
_BITS, _UNIFORM, _NORMAL = 0, 1, 2


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counters ``(x1, x2)`` under key ``(k1, k2)``, as torch ops.

    All four arguments are int64 tensors of uint32 values (the counters
    may also be Python ints) and broadcast against each other.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """The key ``jax.random.key(seed)`` holds (32-bit seeds, as JAX without x64)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


# ---- the kernel path (CUDA tensors)

def _library():
    lib = load_library("bpmf_prng").lib
    if lib.bpmf_prng_keys_launch.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bpmf_prng_keys_launch.argtypes = [ptr, i64, ptr, i32, i64, ctypes.c_uint32, i64, i64, ptr, ptr]
        lib.bpmf_prng_draw_launch.argtypes = [ptr, i64, i64, i32, f32, f32, f32, ptr, ptr]
        lib.bpmf_prng_keys_launch.restype = i32
        lib.bpmf_prng_draw_launch.restype = i32
        lib.bpmf_prng_error_string.argtypes = [i32]
        lib.bpmf_prng_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.bpmf_prng_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda error {err})")


def _check_keys(k: torch.Tensor) -> None:
    if k.dtype != torch.int64 or k.dim() < 1 or k.shape[-1] != 2:
        raise ValueError(f"keys must be an int64 [..., 2] tensor, got {k.dtype} {tuple(k.shape)}")


def _rows(t: torch.Tensor, batch: tuple[int, ...], shape: torch.Size, width: int) -> tuple[torch.Tensor, int]:
    """Operand ``t`` (batch dims ``batch``, then ``width`` trailing) as contiguous rows and a row stride.

    Stride 0 where ``t`` holds one row for every output row, else 1 with
    ``t`` broadcast to ``shape`` first (a copy only where broadcasting
    repeats rows).
    """
    tail = (width,) if width else ()
    if math.prod(batch) == 1:
        return t.reshape(1, *tail).contiguous(), 0
    if tuple(batch) != tuple(shape):
        t = t.expand(*shape, *tail)
    return t.contiguous(), 1


def _launch_keys(lib, k: torch.Tensor, data, num: int | None, stream: int) -> torch.Tensor:
    """``fold_in(k, data)`` (``num`` None) or ``split(k, num)`` (``data`` None) by the kernel, on ``stream``."""
    global LAUNCHES
    _check_keys(k)
    shape, keys, key_stride = k.shape[:-1], k.reshape(-1, 2).contiguous(), 1
    ctr, ctr_bytes, ctr_stride, scalar = None, 0, 0, 0
    if torch.is_tensor(data):
        data = data.to(device=k.device)
        if data.dtype not in (torch.int32, torch.int64):
            data = data.to(torch.int64)
        # numpy's rule is torch's; torch.broadcast_shapes would import sympy (seconds) on its first call
        shape = torch.Size(np.broadcast_shapes(tuple(k.shape[:-1]), tuple(data.shape)))
        keys, key_stride = _rows(k, k.shape[:-1], shape, 2)
        ctr, ctr_stride = _rows(data, data.shape, shape, 0)
        ctr_bytes = ctr.element_size()
    elif data is not None:
        scalar = int(data) & _MASK
    out = torch.empty((*shape, 2) if num is None else (*shape, num, 2), dtype=torch.int64, device=k.device)
    if out.numel() == 0:
        return out
    err = lib.bpmf_prng_keys_launch(
        keys.data_ptr(), key_stride, None if ctr is None else ctr.data_ptr(), ctr_bytes, ctr_stride,
        scalar, math.prod(shape), num or 0, out.data_ptr(), stream,
    )
    _raise_on(lib, err, "bpmf_prng keys")
    LAUNCHES += 1
    return out


def _launch_draw(lib, k: torch.Tensor, shape: tuple[int, ...], kind: int, scale: float, lo: float,
                 stream: int) -> torch.Tensor:
    """``math.prod(shape)`` draws of ``kind`` for each key row of ``k``, on ``stream``."""
    global LAUNCHES
    _check_keys(k)
    keys = k.reshape(-1, 2).contiguous()
    n = math.prod(shape)
    dtype = torch.int64 if kind == _BITS else torch.float32
    out = torch.empty((*k.shape[:-1], *shape), dtype=dtype, device=k.device)
    if out.numel() == 0:
        return out
    err = lib.bpmf_prng_draw_launch(keys.data_ptr(), keys.shape[0], n, kind, scale, lo, _SQRT2,
                                    out.data_ptr(), stream)
    _raise_on(lib, err, "bpmf_prng draw")
    LAUNCHES += 1
    return out


def _stream(k: torch.Tensor) -> int:
    return torch.cuda.current_stream(k.device).cuda_stream


# ---- the plain path (CPU and meta tensors; the kernel's yardstick on the card)

def fold_in_plain(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """:func:`fold_in` as torch ops, on any device."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    if torch.is_tensor(data):
        data = data.to(device=k.device, dtype=torch.int64) & _MASK
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    else:
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & _MASK)
    return torch.stack([y1, y2], dim=-1)


def split_plain(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` as torch ops, on any device."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    counts = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(counts), counts
    )
    return torch.stack([y1, y2], dim=-1)


def random_bits_plain(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """:func:`random_bits` as torch ops, on any device."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0, None], k[..., 1, None], idx >> 32, idx & _MASK)
    return (y1 ^ y2).reshape(*k.shape[:-1], *shape)


def _uniform_scalars(minval: float, maxval: float) -> tuple[float, float]:
    """``(hi - lo, lo)`` as the float32 values a draw on ``[minval, maxval)`` multiplies and adds."""
    # JAX's lo and hi are float32 and hi - lo is taken in float32
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(hi - lo), float(lo)


def uniform_plain(
    k: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """:func:`uniform` as torch ops, on any device."""
    bits = random_bits_plain(k, shape)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    scale, lo = _uniform_scalars(minval, maxval)
    return (floats * scale + lo).clamp_min(lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function in float32, with XLA's polynomial and edge cases."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal_plain(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """:func:`normal` as torch ops, on any device."""
    u = uniform_plain(k, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


# ---- the draws: the kernel on a CUDA tensor, the plain ops elsewhere

def fold_in(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``, batched: ``data`` broadcasts against ``k[..., 0]``.

    An int ``data`` enters the hash as a Python int (no tensor is built
    from it); a tensor one (a device counter) stays on the device.

    Raises:
        ValueError: On a CUDA tensor, keys that are not int64 ``[..., 2]``.
        RuntimeError: The kernel failed to build or to launch.
    """
    if k.device.type == "cuda":
        return _launch_keys(_library(), k, data, None, _stream(k))
    return fold_in_plain(k, data)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys to ``[..., num, 2]`` (raises as :func:`fold_in`)."""
    if k.device.type == "cuda":
        return _launch_keys(_library(), k, None, num, _stream(k))
    return split_plain(k, num)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits`` (32 bits) as int64: ``[..., 2]`` keys to ``[..., *shape]`` (raises as :func:`fold_in`)."""
    if k.device.type == "cuda":
        return _launch_draw(_library(), k, shape, _BITS, 1.0, 0.0, _stream(k))
    return random_bits_plain(k, shape)


def uniform(
    k: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)`` (raises as :func:`fold_in`)."""
    if k.device.type == "cuda":
        return _launch_draw(_library(), k, shape, _UNIFORM, *_uniform_scalars(minval, maxval), _stream(k))
    return uniform_plain(k, shape, minval, maxval)


def normal(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``[..., 2]`` keys to ``[..., *shape]`` (raises as :func:`fold_in`)."""
    if k.device.type == "cuda":
        return _launch_draw(_library(), k, shape, _NORMAL, *_uniform_scalars(_NORMAL_LO, 1.0), _stream(k))
    return normal_plain(k, shape)


def gamma(k: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1) draws in float32, one per entry of ``a`` (Marsaglia–Tsang).

    Each of ``GAMMA_ROUNDS`` (R = 2) rounds draws ``_GAMMA_CANDIDATES``
    (8) proposals per entry from ``fold_in(key, round)``; an entry takes
    the first accepted proposal of the first round that has one. All R
    rounds are drawn, whatever they accept, so the draw reads nothing back
    to the host, and it equals a loop that stops at the first round where
    every entry has a draw wherever that loop stops within R rounds.

    Shapes below one are boosted, ``Gamma(a) = Gamma(a + 1) * U**(1/a)``,
    so the proposals always run at a shape ``a1 >= 1``, where one is
    rejected with probability at most 0.049 (0.0486 at ``a1 = 1``, less
    above). An entry has no accepted proposal in R rounds with probability
    at most ``0.049 ** (8 R) = 1.1e-21``; a sweep draws ``2 K`` entries (the
    Bartlett shapes ``dfs / 2`` of both sides), so at K <= 128 a sweep
    has such an entry with probability below ``3e-19``, under 1e-15. That
    entry is NaN, never a silent 0: it makes the Wishart draw NaN, which
    the sweep's metrics row flags and the engine raises on.
    """
    return _gamma(k, a, fold_in, split, normal, uniform)


def gamma_plain(k: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """:func:`gamma` with every draw on the plain ops, on any device (the card tests' yardstick)."""
    return _gamma(k, a, fold_in_plain, split_plain, normal_plain, uniform_plain)


def _gamma(k, a, fold_in, split, normal, uniform) -> torch.Tensor:
    a = a.to(torch.float32)
    shape = a.shape
    a = a.reshape(-1)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    k_rounds, k_boost = split(k)
    out = torch.full_like(a, float("nan"))
    done = torch.zeros_like(a, dtype=torch.bool)
    for r in range(GAMMA_ROUNDS):
        k_x, k_u = split(fold_in(k_rounds, r))
        x = normal(k_x, (_GAMMA_CANDIDATES, a.numel()))
        u = uniform(k_u, (_GAMMA_CANDIDATES, a.numel()))
        v = (1.0 + c * x) ** 3
        # v <= 0 makes log(v) nan and the comparison false: a rejection
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        first = ok.to(torch.int32).argmax(dim=0, keepdim=True)
        draw = (d * v).gather(0, first)[0]
        found = ok.any(dim=0)
        out = torch.where(found & ~done, draw, out)
        done = done | found
    u_boost = uniform(k_boost, (a.numel(),))
    out = torch.where(boost, out * u_boost ** (1.0 / a), out)
    return out.reshape(shape)
