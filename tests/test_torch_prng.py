"""The port's threefry random numbers against jax.random, and its own gamma.

Keys, bits, fold_in and split must equal JAX's exactly; normals go through
XLA's float32 erfinv polynomial and match to 1e-6. The port's gamma is its
own Marsaglia–Tsang sampler, so it is held to the Gamma distribution.

A CPU or ``meta`` draw takes the plain ops, never the CUDA kernel of
``kernels/csrc/bpmf_prng.cu``. The kernel runs only on the card
(tests/test_torch_cuda.py); here its wrapper is driven with a host model
of the kernel's C interface, which reads the keys and counters at the
pointers the wrapper passes, so the rows, strides, counters and scalars
it hands the kernel are held to the plain ops, and the kernel source's
float32 constants to this module's.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_equal_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_data(jk), tk.numpy())
    for d in (0, 5, 2**31 + 3):
        np.testing.assert_array_equal(
            _data(jax.random.fold_in(jk, np.uint32(d))), prng.fold_in(tk, d).numpy()
        )
    ids = np.arange(0, 1000, 7)
    batched = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(_data(batched), prng.fold_in(tk, torch.from_numpy(ids)).numpy())
    for n in (2, 3, 5):
        np.testing.assert_array_equal(_data(jax.random.split(jk, n)), prng.split(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5)])
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jb, prng.random_bits(tk, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape)), prng.uniform(tk, shape).numpy()
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    jn = np.asarray(jax.random.normal(jk, (20_000,)))
    np.testing.assert_allclose(prng.normal(tk, (20_000,)).numpy(), jn, rtol=0, atol=1e-6)
    # batched keys: per-item noise keyed by item id, as posterior.item_noise draws it
    ids = np.array([0, 3, 99, 1234])
    want = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(jk, i), (8,)))(ids)
    got = prng.normal(prng.fold_in(tk, torch.from_numpy(ids)), (8,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("a", [0.4, 1.0, 2.5, 16.5])
def test_gamma_distribution(a):
    """Kolmogorov-Smirnov against scipy's Gamma(a), plus the first two moments."""
    draws = prng.gamma(prng.key(3), torch.full((40_000,), a)).numpy()
    assert np.isfinite(draws).all() and (draws > 0).all()
    assert scipy.stats.kstest(draws, scipy.stats.gamma(a).cdf).pvalue > 1e-3
    np.testing.assert_allclose(draws.mean(), a, rtol=0.03)
    np.testing.assert_allclose(draws.var(), a, rtol=0.05)


def test_gamma_is_deterministic_in_the_key():
    a = torch.linspace(0.5, 20.0, 32)
    np.testing.assert_array_equal(prng.gamma(prng.key(9), a), prng.gamma(prng.key(9), a))
    assert not torch.equal(prng.gamma(prng.key(9), a), prng.gamma(prng.key(10), a))


def _launch_counts() -> tuple[int, int]:
    return prng.LAUNCHES, prng.PLAIN_CALLS


# (the port's draw on the CPU from key tk, JAX's from key jk, absolute tolerance)
_CPU_DRAWS = {
    "fold_in": (lambda tk: prng.fold_in(tk, 2**31 + 3),
                lambda jk: _data(jax.random.fold_in(jk, np.uint32(2**31 + 3))), 0),
    "split": (lambda tk: prng.split(tk, 3), lambda jk: _data(jax.random.split(jk, 3)), 0),
    "bits": (lambda tk: prng.random_bits(tk, (3, 4)),
             lambda jk: np.asarray(jax.random.bits(jk, (3, 4), jnp.uint32)).astype(np.int64), 0),
    "uniform": (lambda tk: prng.uniform(tk, (2, 3, 5)), lambda jk: np.asarray(jax.random.uniform(jk, (2, 3, 5))), 0),
    "normal": (lambda tk: prng.normal(tk, (5_000,)), lambda jk: np.asarray(jax.random.normal(jk, (5_000,))), 1e-6),
}


@pytest.mark.parametrize("draw", sorted(_CPU_DRAWS))
def test_cpu_draws_take_the_plain_path_and_equal_jax(draw):
    """A draw on CPU tensors is one plain call and no kernel launch, and still equals jax.random."""
    port, ref, atol = _CPU_DRAWS[draw]
    tk = prng.key(11)
    launches, plain = _launch_counts()
    got = port(tk)
    assert _launch_counts() == (launches, plain + 1)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref(jax.random.key(11)), rtol=0, atol=atol)


def test_meta_draws_keep_their_shapes():
    """On ``meta`` tensors (the dry run) every draw takes the plain ops and returns the plain path's shapes and
    dtypes, with no kernel launch."""
    k = prng.key(3, "meta")
    ids = torch.empty(7, dtype=torch.int32, device="meta")
    launches, plain = _launch_counts()
    keys = prng.fold_in(k, ids)
    shapes = {
        "fold_in int": (prng.fold_in(k, 5), (2,), torch.int64),
        "fold_in ids": (keys, (7, 2), torch.int64),
        "split": (prng.split(keys, 3), (7, 3, 2), torch.int64),
        "bits": (prng.random_bits(k, (3, 4)), (3, 4), torch.int64),
        "uniform": (prng.uniform(keys, (2, 5)), (7, 2, 5), torch.float32),
        "normal": (prng.normal(keys, (8,)), (7, 8), torch.float32),
        "gamma": (prng.gamma(k, torch.empty(4, 2, device="meta")), (4, 2), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        assert t.device.type == "meta" and tuple(t.shape) == shape and t.dtype == dtype, name
    assert prng.LAUNCHES == launches
    assert prng.PLAIN_CALLS == plain + 7 + 1 + 4 * prng.GAMMA_ROUNDS  # the gamma: split, 4 a round, the boost


def test_kernel_source_constants_are_the_plain_ops():
    """bpmf_prng.cu's erfinv polynomial is the float32 rounding of this module's, and its output kinds are this
    module's: the kernel cannot run here, so its numbers are read from the source."""
    src = (Path(prng.__file__).resolve().parents[1] / "kernels" / "csrc" / "bpmf_prng.cu").read_text()
    for name, want in (("kErfinvSmall", prng._ERFINV_SMALL), ("kErfinvLarge", prng._ERFINV_LARGE)):
        body = re.search(name + r"\[9\] = \{([^}]*)\}", src).group(1)
        got = np.array([float(v.rstrip("f")) for v in body.replace("\n", " ").split(",") if v.strip()], np.float32)
        np.testing.assert_array_equal(got, np.array(want, np.float32))
    kinds = re.search(r"enum Kind \{ kBits = (\d), kUniform = (\d), kNormal = (\d) \}", src).groups()
    assert tuple(map(int, kinds)) == (prng._BITS, prng._UNIFORM, prng._NORMAL)


def _host(addr: int, dtype, count: int) -> np.ndarray:
    return np.frombuffer((ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(addr), dtype).copy()


class _HostKernel:
    """bpmf_prng.cu's C interface, computed on the host from what lies at the pointers the wrapper passes."""

    def bpmf_prng_keys_launch(self, keys, key_stride, ctr, ctr_bytes, ctr_stride, scalar, rows, n, out, stream):
        per = max(n, 1)
        base = np.arange(rows * per) // per
        words = _host(keys, np.int64, 2 * (rows if key_stride else 1)).reshape(-1, 2)[base * key_stride]
        if n:
            c = np.arange(rows * n) % n
        elif ctr_bytes:
            c = _host(ctr, {4: np.int32, 8: np.int64}[ctr_bytes], rows if ctr_stride else 1)[base * ctr_stride]
            c = c.astype(np.int64) & 0xFFFFFFFF
        else:
            c = np.full(rows, scalar, np.int64)
        y1, y2 = prng.threefry2x32(torch.from_numpy(words[:, 0]), torch.from_numpy(words[:, 1]), 0,
                                   torch.from_numpy(c))
        ctypes.memmove(out, torch.stack([y1, y2], dim=-1).numpy().tobytes(), 16 * rows * per)
        return 0

    def bpmf_prng_draw_launch(self, keys, rows, n, kind, scale, lo, post, out, stream):
        words = _host(keys, np.int64, 2 * rows).reshape(-1, 2)
        i = torch.arange(n, dtype=torch.int64)
        y1, y2 = prng.threefry2x32(torch.from_numpy(words[:, :1]), torch.from_numpy(words[:, 1:]), i >> 32,
                                   i & 0xFFFFFFFF)
        bits = (y1 ^ y2).reshape(-1)
        if kind == prng._BITS:
            res = bits.numpy()
        else:
            f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0).numpy()
            u = np.maximum(f * np.float32(scale) + np.float32(lo), np.float32(lo))
            res = u if kind == prng._UNIFORM else np.float32(post) * prng.erfinv(torch.from_numpy(u)).numpy()
        ctypes.memmove(out, np.ascontiguousarray(res).tobytes(), res.nbytes)
        return 0


def _by_host_kernel(fn):
    launches, plain = _launch_counts()
    out = fn(_HostKernel())
    assert prng.LAUNCHES == launches + 1
    return out, plain


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_kernel_wrapper_hands_the_kernel_the_plain_draws_operands(seed):
    """The wrapper's rows, strides, counters (int, int32 with -1 padding, int64, 0-dim, broadcast) and float
    scalars, read back by a host model of the kernel, give the plain ops' bits, one launch a call."""
    k = prng.key(seed)
    rows = prng.split_plain(k, 6).reshape(2, 3, 2)
    col = prng.split_plain(k, 3)[:, None, :]
    cases = [
        (lambda lib: prng._launch_keys(lib, k, 2**31 + 3, None, 0), lambda: prng.fold_in_plain(k, 2**31 + 3)),
        (lambda lib: prng._launch_keys(lib, rows, 11, None, 0), lambda: prng.fold_in_plain(rows, 11)),
        (lambda lib: prng._launch_keys(lib, rows[:, 1], 4, None, 0), lambda: prng.fold_in_plain(rows[:, 1], 4)),
    ]
    for data in (torch.tensor([-1, 0, 3, 2**31 - 1], dtype=torch.int32), torch.arange(0, 70, 7),
                 torch.tensor(9, dtype=torch.int32), torch.tensor([2**33 + 4, -5])):
        cases.append((lambda lib, d=data: prng._launch_keys(lib, k, d, None, 0), lambda d=data: prng.fold_in_plain(k, d)))
        cases.append((lambda lib, d=data: prng._launch_keys(lib, rows[0], d.reshape(-1)[:1].expand(3), None, 0),
                      lambda d=data: prng.fold_in_plain(rows[0], d.reshape(-1)[:1].expand(3))))
    grid = torch.arange(12).reshape(3, 4)
    cases.append((lambda lib: prng._launch_keys(lib, col, grid, None, 0), lambda: prng.fold_in_plain(col, grid)))
    for n in (1, 2, 5):
        cases.append((lambda lib, n=n: prng._launch_keys(lib, rows, None, n, 0), lambda n=n: prng.split_plain(rows, n)))
    ids = prng.fold_in_plain(k, torch.tensor([-1, 0, 5, 99]))
    cases += [
        (lambda lib: prng._launch_draw(lib, k, (3, 4), prng._BITS, 1.0, 0.0, 0), lambda: prng.random_bits_plain(k, (3, 4))),
        (lambda lib: prng._launch_draw(lib, ids, (2, 5), prng._BITS, 1.0, 0.0, 0),
         lambda: prng.random_bits_plain(ids, (2, 5))),
        (lambda lib: prng._launch_draw(lib, ids, (7,), prng._UNIFORM, *prng._uniform_scalars(-3.0, 2.5), 0),
         lambda: prng.uniform_plain(ids, (7,), -3.0, 2.5)),
        (lambda lib: prng._launch_draw(lib, ids, (32,), prng._NORMAL, *prng._uniform_scalars(prng._NORMAL_LO, 1.0), 0),
         lambda: prng.normal_plain(ids, (32,))),
    ]
    for kernel, plain in cases:
        got, plain_calls = _by_host_kernel(kernel)
        assert prng.PLAIN_CALLS == plain_calls
        want = plain()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_kernel_wrapper_raises_on_bad_keys_and_failed_launches():
    """Keys that are not int64 ``[..., 2]`` raise before any launch, and a launch error is raised, not ignored."""
    class Failing(_HostKernel):
        def bpmf_prng_draw_launch(self, *args):
            return 700

        def bpmf_prng_error_string(self, code):
            return b"an illegal memory access was encountered"

    for bad in (prng.key(1).to(torch.int32), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="int64"):
            prng._launch_draw(_HostKernel(), bad, (4,), prng._BITS, 1.0, 0.0, 0)
        with pytest.raises(ValueError, match="int64"):
            prng._launch_keys(_HostKernel(), bad, 3, None, 0)
    launches = prng.LAUNCHES
    with pytest.raises(RuntimeError, match="illegal memory access"):
        prng._launch_draw(Failing(), prng.key(1), (4,), prng._NORMAL, 1.0, 0.0, 0)
    assert prng.LAUNCHES == launches


# ---- jax.random's draws, stored for the card (whose machine has no JAX)

# tests/test_torch_cuda.py holds the kernel to these arrays on the card: the
# integers and uniforms on [0, 1) exactly, the normals to 1e-6, as the tests
# above hold the plain ops on the CPU. A uniform on another range is held to
# one rounding of its product: XLA rounds f * (hi - lo) + lo once (a fused
# multiply-add), the port twice, as a multiply and an add, so the two differ
# by at most a float32 ulp of hi - lo. The sampler draws no such range
# (gamma's are [0, 1), and the normal's scale, 2.0, makes the product exact).
# Regenerate with `python tests/test_torch_prng.py`.
JAX_DRAWS = Path(__file__).parent / "data" / "prng_jax_draws.npz"
JAX_DRAW_SEEDS = (0, 7, 2**31 - 1)
JAX_DRAW_SHAPES = ((1,), (5,), (3, 4), (2, 3, 5))
# item_noise at ChEMBL's size: 483,500 compounds (the last 1,000 ids padded to -1), K = 32,
# under fold_in(key(2718), 3); the rows stored are 1,024 evenly spaced ids and one padded row
ITEM_NOISE_B, ITEM_NOISE_K, ITEM_NOISE_PAD = 483_500, 32, 1_000
# every 5th of 20,000 normals from each seed's key
NORMAL_N, NORMAL_EVERY = 20_000, 5
# the gap allowed a uniform on [-3, 2.5): one float32 ulp of 5.5
RANGE_ATOL = float(np.spacing(np.float32(5.5)))


def _shape_name(shape: tuple[int, ...]) -> str:
    return "x".join(map(str, shape))


def _jax_draws() -> dict[str, np.ndarray]:
    """The arrays of ``JAX_DRAWS``, drawn by jax.random on the CPU, by kind (``<kind>`` or ``<kind>/<case>``)."""
    out: dict[str, np.ndarray] = {}
    keys = [jax.random.key(s) for s in JAX_DRAW_SEEDS]
    ints = np.array([0, 5, 2**31 + 3], dtype=np.int64)
    ids = np.array([-1, 0, 3, 2**31 - 1, *range(0, 1000, 7)], dtype=np.int32)
    out["fold_in/ints"] = ints
    out["fold_in/ids"] = ids
    out["fold_in/by_int"] = np.stack([[_data(jax.random.fold_in(k, np.uint32(d))) for d in ints] for k in keys])
    out["fold_in/by_ids"] = np.stack([_data(jax.vmap(lambda i, k=k: jax.random.fold_in(k, i))(jnp.asarray(ids)))
                                      for k in keys])
    for n in (2, 3, 5):
        out[f"split/{n}"] = np.stack([_data(jax.random.split(k, n)) for k in keys])
    for shape in JAX_DRAW_SHAPES:
        name = _shape_name(shape)
        out[f"bits/{name}"] = np.stack([np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
                                        for k in keys])
        out[f"uniform/{name}"] = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
        out[f"uniform/{name}_on_-3_2.5"] = np.stack([np.asarray(jax.random.uniform(k, shape, minval=-3.0, maxval=2.5))
                                                     for k in keys])
    out["normal"] = np.stack([np.asarray(jax.random.normal(k, (NORMAL_N,)))[::NORMAL_EVERY] for k in keys])
    rows = np.append(np.linspace(0, ITEM_NOISE_B - ITEM_NOISE_PAD - 1, 1024).astype(np.int64), ITEM_NOISE_B - 1)
    row_ids = np.where(rows >= ITEM_NOISE_B - ITEM_NOISE_PAD, -1, rows).astype(np.int32)
    key = jax.random.fold_in(jax.random.key(2718), 3)
    out["item_noise/rows"] = rows
    out["item_noise"] = np.asarray(jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(key, i), (ITEM_NOISE_K,)))(
        jnp.asarray(row_ids)))
    return out


def _stored_jax_draws() -> dict[str, np.ndarray]:
    with np.load(JAX_DRAWS) as f:
        return {name: f[name] for name in f.files}


_JAX_DRAW_KINDS = ("fold_in", "split", "bits", "uniform", "normal", "item_noise")


@pytest.mark.parametrize("kind", _JAX_DRAW_KINDS)
def test_stored_jax_draws_are_jax_random(kind):
    """The arrays the card tests hold the kernel to are jax.random's draws, bit for bit, and the port's plain ops on
    the CPU give them (integers and uniforms exactly, normals to 1e-6)."""
    stored = {n: a for n, a in _stored_jax_draws().items() if n.split("/")[0] == kind}
    drawn = {n: a for n, a in _jax_draws().items() if n.split("/")[0] == kind}
    assert stored.keys() == drawn.keys() and stored
    for name, want in drawn.items():
        assert stored[name].dtype == want.dtype and stored[name].shape == want.shape, name
        np.testing.assert_array_equal(stored[name], want, err_msg=name)
    tk = [prng.key(s) for s in JAX_DRAW_SEEDS]
    if kind == "fold_in":
        got = np.stack([[prng.fold_in(k, int(d)).numpy() for d in stored["fold_in/ints"]] for k in tk])
        np.testing.assert_array_equal(got, stored["fold_in/by_int"])
        ids = torch.from_numpy(stored["fold_in/ids"])
        np.testing.assert_array_equal(np.stack([prng.fold_in(k, ids).numpy() for k in tk]), stored["fold_in/by_ids"])
    elif kind == "split":
        for n in (2, 3, 5):
            np.testing.assert_array_equal(np.stack([prng.split(k, n).numpy() for k in tk]), stored[f"split/{n}"])
    elif kind in ("bits", "uniform"):
        for shape in JAX_DRAW_SHAPES:
            name = _shape_name(shape)
            if kind == "bits":
                got = np.stack([prng.random_bits(k, shape).numpy() for k in tk])
                np.testing.assert_array_equal(got, stored[f"bits/{name}"])
            else:
                np.testing.assert_array_equal(np.stack([prng.uniform(k, shape).numpy() for k in tk]),
                                              stored[f"uniform/{name}"])
                got = np.stack([prng.uniform(k, shape, -3.0, 2.5).numpy() for k in tk])
                np.testing.assert_allclose(got, stored[f"uniform/{name}_on_-3_2.5"], rtol=0, atol=RANGE_ATOL)
    elif kind == "normal":
        got = np.stack([prng.normal(k, (NORMAL_N,)).numpy()[::NORMAL_EVERY] for k in tk])
        np.testing.assert_allclose(got, stored["normal"], rtol=0, atol=1e-6)
    else:
        rows = stored["item_noise/rows"]
        ids = torch.from_numpy(np.where(rows >= ITEM_NOISE_B - ITEM_NOISE_PAD, -1, rows).astype(np.int32))
        got = prng.normal(prng.fold_in(prng.fold_in(prng.key(2718), 3), ids), (ITEM_NOISE_K,))
        np.testing.assert_allclose(got.numpy(), stored["item_noise"], rtol=0, atol=1e-6)


if __name__ == "__main__":
    JAX_DRAWS.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_DRAWS, **_jax_draws())
    print(JAX_DRAWS)
