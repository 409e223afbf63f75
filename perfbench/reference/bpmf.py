"""Plain Bayesian probabilistic matrix factorization by Gibbs sampling: the benchmark's reference.

Salakhutdinov and Mnih (ICML 2008), in the order of Algorithm 1 of Vander
Aa et al. (arXiv:1705.04159): per sweep, draw the movies' hyper-parameters
from V, every movie from U and the ratings, the users' hyper-parameters
from U, every user from the new V, then predict the held-out ratings.

It follows the sampler's published conventions so that its draws can be
compared with the program's one by one:

* the held-out ratings are those whose draw from numpy's
  ``default_rng(seed).random(nnz)`` is below the test fraction; the rest
  are centred on their mean; predictions are clipped to the range of all
  ratings;
* the run key is ``split(key(seed))[1]``; sweep ``s`` (from 0) draws with
  ``fold_in(fold_in(run_key, s), i)`` for i = 0..3 (movies' hyper-parameters,
  movies, users' hyper-parameters, users); an item's noise is
  ``normal(fold_in(k, item_id), (K,))``; the initial rows are
  ``0.1 * normal(fold_in(k, item_id), (K,))`` under ``split(split(key(seed))[0])``;
* the Normal-Wishart prior is ``mu0 = 0``, ``W0 = I``, ``nu0 = K`` and
  ``beta0`` of the configuration; Lambda is drawn by Bartlett's
  decomposition with ``chi2(nu - i) = 2 Gamma((nu - i) / 2)``, then
  ``mu ~ N(mu*, (beta* Lambda)^-1)``; a small ``1e-10 I`` steadies the two
  Cholesky factors of the hyper-parameter draw;
* the posterior mean of the test predictions averages the sweeps past
  ``burn_in``.

Nothing here is bucketed, padded, sharded or fused: each sum runs over the
ratings themselves (``index_add_``), each item's draw is one Cholesky factor
and triangular solves. The linear algebra runs in the precision of
:class:`Precision`: float64 for the reference, float32 with every matrix
product's inputs rounded to TF32 for the control that has to fail. The
random variates are float32 by their specification (:mod:`.rng`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import rng

# ratings per index_add_ chunk: [CHUNK, K * K] outer products at a time
CHUNK = 1 << 17


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where the linear algebra runs: its float type, and whether products see TF32 inputs."""

    dtype: torch.dtype
    tf32: bool = False

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in this precision's type, its mantissa cut to TF32's 10 bits when ``tf32``."""
        x = x.to(self.dtype)
        if not self.tf32:
            return x
        b = x.to(torch.float32).view(torch.int32)
        return ((b + 0x1000) & ~0x1FFF).view(torch.float32).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.rounded(a) @ self.rounded(b)


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, tf32=True)


@dataclasses.dataclass
class Side:
    """The training ratings seen from one side: rating r links ``item[r]`` to ``nbr[r]``."""

    item: torch.Tensor  # [nnz] int64
    nbr: torch.Tensor  # [nnz] int64
    val: torch.Tensor  # [nnz] float64, centred
    num_items: int


@dataclasses.dataclass
class Data:
    users: Side
    movies: Side
    test_rows: torch.Tensor
    test_cols: torch.Tensor
    test_vals: torch.Tensor  # float64, not centred
    mean: float
    lo: float
    hi: float


def held_out(nnz: int, test_fraction: float, seed: int) -> np.ndarray:
    """The mask of held-out ratings."""
    return np.random.default_rng(seed).random(nnz) < test_fraction


def build(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, num_users: int, num_movies: int,
          test_fraction: float, seed: int, device) -> Data:
    test = torch.from_numpy(held_out(len(rows), test_fraction, seed)).to(device)
    r = torch.from_numpy(np.asarray(rows, np.int64)).to(device)
    c = torch.from_numpy(np.asarray(cols, np.int64)).to(device)
    v = torch.from_numpy(np.asarray(vals, np.float32)).to(device, torch.float64)
    train = ~test
    mean = float(v[train].mean())
    centred = v[train] - mean
    return Data(
        users=Side(r[train], c[train], centred, num_users),
        movies=Side(c[train], r[train], centred, num_movies),
        test_rows=r[test], test_cols=c[test], test_vals=v[test],
        mean=mean, lo=float(v.min()), hi=float(v.max()),
    )


def gram(X: torch.Tensor, side: Side, alpha: float, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """``alpha * sum x x^T`` and ``alpha * sum x r`` over each item's ratings."""
    K = X.shape[1]
    Xr = prec.rounded(X)
    G = torch.zeros(side.num_items, K * K, dtype=prec.dtype, device=X.device)
    g = torch.zeros(side.num_items, K, dtype=prec.dtype, device=X.device)
    for lo in range(0, side.item.numel(), CHUNK):
        item = side.item[lo:lo + CHUNK]
        x = Xr[side.nbr[lo:lo + CHUNK]]
        G.index_add_(0, item, (x[:, :, None] * x[:, None, :]).reshape(-1, K * K))
        g.index_add_(0, item, x * side.val[lo:lo + CHUNK, None].to(prec.dtype))
    return alpha * G.reshape(-1, K, K), alpha * g


def update_side(key: torch.Tensor, X_opp: torch.Tensor, side: Side, mu: torch.Tensor, Lam: torch.Tensor,
                alpha: float, prec: Precision) -> torch.Tensor:
    """Every item of ``side`` drawn from its Gaussian conditional given ``X_opp``."""
    K = X_opp.shape[1]
    G, g = gram(X_opp, side, alpha, prec)
    L = torch.linalg.cholesky_ex(G + Lam)[0]
    lin = g + prec.mm(Lam, mu[:, None])[:, 0]
    ids = torch.arange(side.num_items, device=X_opp.device)
    z = rng.normal(rng.fold_in(key, ids), (K,)).to(prec.dtype)
    y = torch.linalg.solve_triangular(L, lin[:, :, None], upper=False)
    both = torch.linalg.solve_triangular(L.transpose(1, 2), torch.cat([y, z[:, :, None]], dim=2), upper=True)
    return both[:, :, 0] + both[:, :, 1]


def sample_hyper(key: torch.Tensor, X: torch.Tensor, beta0: float, prec: Precision):
    """``(mu, Lambda)`` from their Normal-Wishart conditional given the rows of X."""
    n, K = X.shape
    dt, dev = prec.dtype, X.device
    eye = torch.eye(K, dtype=dt, device=dev)
    xbar = X.sum(dim=0) / n
    S = prec.mm(X.T, X) / n - torch.outer(xbar, xbar)
    S = 0.5 * (S + S.T)
    beta_s, nu_s = beta0 + n, K + n
    mu_s = n * xbar / beta_s
    W_inv = eye + n * S + (beta0 * n / beta_s) * torch.outer(xbar, xbar)
    W = torch.linalg.inv_ex(0.5 * (W_inv + W_inv.T))[0]
    C = torch.linalg.cholesky_ex(0.5 * (W + W.T) + 1e-10 * eye)[0]
    k_lam, k_mu = rng.split(key)
    k_n, k_c = rng.split(k_lam)
    # the Bartlett shapes (nu - i) / 2 are whole or half numbers, exact in float32
    shapes = torch.from_numpy((np.float32(nu_s) - np.arange(K, dtype=np.float32)) / np.float32(2)).to(dev)
    chi2 = 2.0 * rng.gamma(k_c, shapes)
    A = torch.tril(rng.normal(k_n, (K, K)).to(dt), -1) + torch.diag(torch.sqrt(chi2.to(dt)))
    LA = prec.mm(C, A)
    Lam = prec.mm(LA, LA.T)
    Lam = 0.5 * (Lam + Lam.T)
    L = torch.linalg.cholesky_ex(Lam + 1e-10 * eye)[0]
    z = rng.normal(k_mu, (K,)).to(dt)
    mu = mu_s + torch.linalg.solve_triangular(L.T, z[:, None], upper=True)[:, 0] / float(np.sqrt(beta_s))
    return mu, Lam


def predict(U: torch.Tensor, V: torch.Tensor, data: Data) -> torch.Tensor:
    return ((U[data.test_rows] * V[data.test_cols]).sum(dim=1) + data.mean).clamp(data.lo, data.hi)


def rmse(pred: torch.Tensor, vals: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((pred - vals.to(pred.dtype)) ** 2)))


def init_rows(k: torch.Tensor, n: int, K: int, prec: Precision) -> torch.Tensor:
    ids = torch.arange(n, device=k.device)
    return (0.1 * rng.normal(rng.fold_in(k, ids), (K,))).to(prec.dtype)


def run(seed: int, data: Data, K: int, alpha: float, beta0: float, burn_in: int, sweeps: int,
        prec: Precision = REFERENCE) -> dict:
    """The first ``sweeps`` sweeps from the seed.

    Returns:
        ``U``, ``V``, ``mu_U``, ``Lam_U``, ``mu_V``, ``Lam_V`` after the last
        sweep, and ``rmse`` ``[sweeps, 2]``: each sweep's test RMSE of its own
        sample and of the posterior mean so far (the sample's own before
        ``burn_in`` has passed).
    """
    device = data.test_vals.device
    k_init, k_run = rng.split(rng.key(seed, device))
    ku, kv = rng.split(k_init)
    U = init_rows(ku, data.users.num_items, K, prec)
    V = init_rows(kv, data.movies.num_items, K, prec)
    total = torch.zeros_like(data.test_vals, dtype=prec.dtype)
    count = 0
    rows = []
    for s in range(sweeps):
        k = rng.fold_in(k_run, s)
        k_hv, k_v, k_hu, k_u = (rng.fold_in(k, i) for i in range(4))
        mu_V, Lam_V = sample_hyper(k_hv, V, beta0, prec)
        V = update_side(k_v, U, data.movies, mu_V, Lam_V, alpha, prec)
        mu_U, Lam_U = sample_hyper(k_hu, U, beta0, prec)
        U = update_side(k_u, V, data.users, mu_U, Lam_U, alpha, prec)
        pred = predict(U, V, data)
        sample = rmse(pred, data.test_vals)
        if s + 1 > burn_in:
            total += pred
            count += 1
        rows.append((sample, rmse(total / count, data.test_vals) if count else sample))
    return {"U": U, "V": V, "mu_U": mu_U, "Lam_U": Lam_U, "mu_V": mu_V, "Lam_V": Lam_V,
            "rmse": np.asarray(rows, np.float64)}
