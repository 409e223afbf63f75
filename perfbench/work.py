"""The yardstick's arithmetic: operations and bytes from shapes, and the chips' peaks.

Counts are what the inputs need, never what a kernel happens to move:
each input byte read once, each output byte written once, and the
operations of the algorithm at these shapes.

``gram_work`` is a frozen copy of the port's ``kernels/bpmf_gram.py``
count (8 bytes and K (K + 3) flops a rating, X read once, G and g written
once). A sweep's Gram need (:func:`sweep_gram_need`) applies it once per
side, as one call over all of that side's ratings, whatever layout the
program chose. The port's ``fused_work`` also counts the ring's per-step
reads and writes of partial G rows; the inputs do not need those, so the
fused kernel is held to the same need as the bucketed one.
"""
from __future__ import annotations

# Published dense peaks (NVIDIA's data sheet, SXM part), valid at the card's
# full power limit of 700 W; a card set lower runs slower under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,  # outside the tensor cores: the configurations state float32, TF32 off
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, what: str) -> float | None:
    """The peak ``what`` of a card named ``kind``, or ``None`` for a card not in the table."""
    return PEAKS.get(kind, {}).get(what)


def gram_work(nnz_total: int, B: int, Ns: int, K: int) -> tuple[float, float]:
    """(bytes, flops) of one per-bucket Gram call: ids, values, nnz, X once, G and g once."""
    bytes_ = 8.0 * nnz_total + 4.0 * B + 4.0 * Ns * K + 4.0 * B * (K * K + K)
    return bytes_, float(nnz_total) * K * (K + 3)


def sweep_gram_need(n_train: int, num_users: int, num_movies: int, K: int) -> tuple[float, float]:
    """(bytes, flops) of one sweep's Gram products: both sides, each as one call over all its ratings."""
    movies = gram_work(n_train, num_movies, num_users, K)
    users = gram_work(n_train, num_users, num_movies, K)
    return movies[0] + users[0], movies[1] + users[1]


def row_draw_flops(K: int) -> float:
    """Flops of one item's draw given its Gram terms.

    The precision ``G + Lambda`` (K^2) and linear term (K), the Cholesky
    factor (K^3 / 3), the forward solve (K^2), the backward solve with the
    mean and the noise as two right-hand sides (2 K^2), and their sum (K).
    """
    return K ** 3 / 3.0 + 4.0 * K * K + 2.0 * K


def sweep_flops(n_train: int, n_test: int, num_users: int, num_movies: int, K: int) -> float:
    """Flops one Gibbs sweep needs: the Gram products, every row's draw, the
    hyper-parameter statistics ``X^T X`` of both sides, and the test predictions."""
    rows = num_users + num_movies
    gram = sweep_gram_need(n_train, num_users, num_movies, K)[1]
    hyper = 2.0 * rows * K * K
    return gram + rows * row_draw_flops(K) + hyper + 2.0 * n_test * K


def topk_flops(B: int, N: int, K: int) -> float:
    """Flops of scoring ``B`` users against a catalog of ``N`` items at rank ``K``."""
    return 2.0 * B * N * K


def roofline_s(bytes_: float, flops: float, kind: str) -> float | None:
    """The least time the card could take: the larger of float32 flops over peak and bytes over bandwidth."""
    f, b = peak(kind, "f32_flops"), peak(kind, "hbm_bytes_per_s")
    if f is None or b is None:
        return None
    return max(flops / f, bytes_ / b)
