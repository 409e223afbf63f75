"""Counter-based random numbers: JAX's threefry2x32 written as torch integer ops.

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

The uint32 words are held in int64 and masked to 32 bits after every add
and shift, so the same code runs on the CPU and on the GPU.

``gamma`` is this package's own Marsaglia–Tsang sampler on these bits. It
is deterministic in the key, but it is not ``jax.random.gamma`` bit for
bit: that is a rejection sampler with its own key schedule. It is the one
draw that the parity tests replace with JAX's (they monkeypatch this
module's ``gamma``), which is why callers reach it as ``prng.gamma``.

Nothing here reads a tensor back to the host or builds a device tensor
from host data: integer arguments enter the hash as Python ints, and the
float constants are Python floats (exact in float32, and only multiplied,
added or compared, never divided by), so every draw can be captured in a
CUDA graph.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counters ``(x1, x2)`` under key ``(k1, k2)``.

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


def fold_in(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``, batched: ``data`` broadcasts against ``k[..., 0]``.

    An int ``data`` enters the hash as a Python int (no tensor is built
    from it); a tensor one (a device counter) stays on the device.
    """
    if torch.is_tensor(data):
        data = data.to(device=k.device, dtype=torch.int64) & _MASK
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    else:
        y1, y2 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & _MASK)
    return torch.stack([y1, y2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys to ``[..., num, 2]``."""
    counts = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(counts), counts
    )
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits`` (32 bits) as int64: ``[..., 2]`` keys to ``[..., *shape]``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0, None], k[..., 1, None], idx >> 32, idx & _MASK)
    return (y1 ^ y2).reshape(*k.shape[:-1], *shape)


def uniform(
    k: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    bits = random_bits(k, shape)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    # JAX's lo and hi are float32 and hi - lo is taken in float32
    lo, hi = np.float32(minval), np.float32(maxval)
    return (floats * float(hi - lo) + float(lo)).clamp_min(float(lo))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function in float32, with XLA's polynomial and edge cases."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``[..., 2]`` keys to ``[..., *shape]``."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


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
