"""The sampler's random numbers, written from their specification.

The sampler draws every variate from JAX's counter-based threefry2x32
generator in its partitionable layout, and the reference draws them the
same way, so both sides see the same noise from the same seed:

* a key is two uint32 words, held here as an int64 tensor ``[..., 2]``;
  ``key(seed)`` is ``(0, seed mod 2**32)``;
* ``fold_in(k, d)`` is the hash of the counter ``(0, d)`` under ``k``, and
  ``split(k, n)[i]`` the hash of ``(0, i)``;
* ``bits(k, shape)`` hashes the flat counter ``i`` as ``(i >> 32, i mod
  2**32)`` and xors the two output words;
* a uniform float32 takes the top 23 bits as the mantissa of a number in
  ``[1, 2)`` and subtracts one; a normal is ``sqrt(2) * erfinv(u)`` on
  ``u`` uniform in ``[nextafter(-1, 0), 1)``, with the single-precision
  ``erfinv`` polynomial of M. Giles (as XLA expands it);
* a gamma variate is Marsaglia and Tsang's method in float32: two rounds
  of eight proposals each, the first accepted proposal of the first round
  that has one, shapes below one boosted by ``U ** (1 / a)``.

These variates are float32 by their specification and are computed in
float32 here, op for op as the specification states them. That matters for
the gamma draws: at the shapes the sampler uses (half the number of rows
of a side, tens of thousands) the acceptance test cancels terms of that
size, so its float32 rounding decides about one proposal in a hundred. The
reference therefore evaluates the same float32 expression on the same
device; everything that is not a variate it computes in float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
ERFINV_SMALL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_LARGE = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
GAMMA_ROUNDS = 2
GAMMA_PROPOSALS = 8


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry(k0, k1, x0, x1):
    """threefry2x32 with 20 rounds: the two output words of counter ``(x0, x1)`` under key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Fold ``data`` (an int, or an int tensor broadcast against the keys) into ``k``."""
    if torch.is_tensor(data):
        data = data.to(device=k.device, dtype=torch.int64) & MASK
        a, b = threefry(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    else:
        a, b = threefry(k[..., 0], k[..., 1], 0, int(data) & MASK)
    return torch.stack([a, b], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    a, b = threefry(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = threefry(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK)
    return (a ^ b).reshape(*k.shape[:-1], *shape)


def uniform(k: torch.Tensor, shape: tuple[int, ...], lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    mantissa = ((bits(k, shape) >> 9) | 0x3F800000).to(torch.int32)
    unit = mantissa.view(torch.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return (unit * float(hi32 - lo32) + float(lo32)).clamp_min(float(lo32))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_SMALL[0], ERFINV_LARGE[0])
    for cs, cl in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def normal(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    return _SQRT2 * erfinv(uniform(k, shape, _NORMAL_LO, 1.0))


def gamma(k: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1) variates in float32, one per entry of ``a``; NaN where no proposal was accepted."""
    a = a.to(torch.float32).reshape(-1)
    n = a.numel()
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    k_rounds, k_boost = split(k)
    out = torch.full_like(a, float("nan"))
    done = torch.zeros_like(a, dtype=torch.bool)
    for r in range(GAMMA_ROUNDS):
        k_x, k_u = split(fold_in(k_rounds, r))
        x = normal(k_x, (GAMMA_PROPOSALS, n))
        u = uniform(k_u, (GAMMA_PROPOSALS, n))
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        first = ok.to(torch.int32).argmax(dim=0, keepdim=True)
        found = ok.any(dim=0)
        out = torch.where(found & ~done, (d * v).gather(0, first)[0], out)
        done = done | found
    u_boost = uniform(k_boost, (n,))
    return torch.where(boost, out * u_boost ** (1.0 / a), out)
