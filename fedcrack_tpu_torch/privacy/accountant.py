"""RDP/moments accountant for DP-SGD (Abadi et al. 2016; Mironov 2017).

The counterpart of ``fedcrack_tpu.privacy.accountant``, the same
operations in the same order, so every epsilon is the same Python float.

The mechanism being accounted is the subsampled Gaussian: each step, a
q-fraction sample of the data contributes a gradient clipped to L2 norm
``C`` with ``N(0, (sigma * C)^2)`` noise added. Composition is tracked in
Renyi differential privacy (additive across steps at each order) and
converted to an ``(epsilon, delta)`` guarantee at report time:

    eps(delta) = min over orders a of  T * RDP(a) + log(1/delta) / (a - 1)

For integer orders the subsampled-Gaussian RDP has the closed form
(Mironov/Talwar/Zhang 2019, eq. 6):

    RDP(a) = 1/(a-1) * log( sum_{k=0}^{a} C(a,k) (1-q)^(a-k) q^k
                            * exp(k(k-1) / (2 sigma^2)) )

evaluated in log space (lgamma binomials and logsumexp) so large orders do
not overflow. ``q = 1`` collapses to the plain Gaussian mechanism's
``RDP(a) = a / (2 sigma^2)`` and ``q = 0`` to zero cost.

:class:`PrivacyAccountant` is the per-client ledger the round machine
drives: epsilon is a pure function of the per-client step count (its only
state), so the statefile keeps the sorted ``[name, steps]`` rows and a
restart recomputes the same epsilons bit for bit.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

# Integer Renyi orders the closed form is evaluated at: dense where the
# optimum usually lands for federation-scale (q, sigma), sparse above.
DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 65)) + (80, 96, 128, 256, 512)


def _log_binom(a: int, k: int) -> float:
    return math.lgamma(a + 1) - math.lgamma(k + 1) - math.lgamma(a - k + 1)


def _logsumexp(xs: Sequence[float]) -> float:
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_subsampled_gaussian(
    q: float,
    noise_multiplier: float,
    steps: int = 1,
    orders: Sequence[int] = DEFAULT_ORDERS,
) -> tuple[float, ...]:
    """RDP of ``steps`` compositions of the subsampled Gaussian at each
    integer order. ``q`` is the per-step sampling rate, ``noise_multiplier``
    the noise-to-clip ratio sigma."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
    if noise_multiplier <= 0.0:
        raise ValueError(f"noise_multiplier must be > 0 to account, got {noise_multiplier}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    sigma2 = float(noise_multiplier) ** 2
    out = []
    for a in orders:
        if a < 2 or a != int(a):
            raise ValueError(f"orders must be integers >= 2, got {a}")
        if q == 0.0:
            out.append(0.0)
        elif q == 1.0:
            out.append(steps * a / (2.0 * sigma2))
        else:
            terms = [
                _log_binom(a, k)
                + (a - k) * math.log1p(-q)
                + (k * math.log(q) if k else 0.0)
                + k * (k - 1) / (2.0 * sigma2)
                for k in range(a + 1)
            ]
            out.append(steps * _logsumexp(terms) / (a - 1))
    return tuple(out)


def rdp_to_epsilon(rdp: Sequence[float], orders: Sequence[int], delta: float) -> tuple[float, int]:
    """The RDP -> (eps, delta) conversion (Mironov 2017, prop. 3):
    ``eps = min_a [rdp(a) + log(1/delta)/(a-1)]``. Returns ``(eps,
    order)``, the order where the minimum landed."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    if len(rdp) != len(orders):
        raise ValueError("rdp/orders length mismatch")
    log_inv_delta = math.log(1.0 / delta)
    return min(((r + log_inv_delta / (a - 1), a) for r, a in zip(rdp, orders)), key=lambda t: t[0])


def compute_epsilon(
    q: float,
    noise_multiplier: float,
    steps: int,
    delta: float,
    orders: Sequence[int] = DEFAULT_ORDERS,
) -> float:
    """One-shot eps(delta) after ``steps`` subsampled-Gaussian steps."""
    if steps == 0:
        return 0.0
    rdp = rdp_subsampled_gaussian(q, noise_multiplier, steps, orders)
    return rdp_to_epsilon(rdp, orders, delta)[0]


class PrivacyAccountant:
    """Per-client cumulative privacy loss for one federation.

    The only mutable state is ``steps[name]``, how many noise additions
    that client's data has been through. The per-step RDP vector is
    computed once; ``epsilon_of`` is a min over orders, cheap enough to
    record into every round's history entry."""

    def __init__(
        self,
        noise_multiplier: float,
        sample_rate: float,
        delta: float = 1e-5,
        orders: Sequence[int] = DEFAULT_ORDERS,
    ):
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.noise_multiplier = float(noise_multiplier)
        self.sample_rate = float(sample_rate)
        self.delta = float(delta)
        self.orders = tuple(int(a) for a in orders)
        self._rdp_step = rdp_subsampled_gaussian(self.sample_rate, self.noise_multiplier, 1, self.orders)
        self.steps: dict[str, int] = {}

    def record(self, clients: Iterable[str], steps: int = 1) -> None:
        """Charge ``steps`` compositions to each named client."""
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        for name in clients:
            self.steps[name] = self.steps.get(name, 0) + int(steps)

    def epsilon_of(self, name: str) -> float:
        t = self.steps.get(name, 0)
        if t == 0:
            return 0.0
        rdp = [r * t for r in self._rdp_step]
        return rdp_to_epsilon(rdp, self.orders, self.delta)[0]

    def epsilons(self) -> dict[str, float]:
        """``{name: eps}`` over every charged client, sorted by name."""
        return {n: self.epsilon_of(n) for n in sorted(self.steps)}

    def max_epsilon(self) -> float:
        return max((self.epsilon_of(n) for n in self.steps), default=0.0)

    def summary(self) -> dict:
        """Parameters and per-client steps and epsilon, sorted and rounded."""
        return {
            "noise_multiplier": self.noise_multiplier,
            "sample_rate": self.sample_rate,
            "delta": self.delta,
            "clients": {
                n: {"steps": self.steps[n], "epsilon": round(self.epsilon_of(n), 6)}
                for n in sorted(self.steps)
            },
            "max_epsilon": round(self.max_epsilon(), 6),
        }

    def to_wire(self) -> list:
        """Sorted ``[name, steps]`` rows; epsilon is recomputed, never
        stored, so a snapshot cannot disagree with the math."""
        return [[n, int(self.steps[n])] for n in sorted(self.steps)]

    def load_wire(self, rows: Iterable) -> None:
        self.steps = {str(n): int(t) for n, t in rows}
