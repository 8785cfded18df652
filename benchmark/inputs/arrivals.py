"""Seeded open-loop send schedules.

A frozen copy of ``fedcrack_tpu_torch/tools/load_gen.py::arrival_schedule``
and its phase tables, for open-loop traffic: ``const`` sends at a fixed
period; ``ramp`` and ``diurnal`` draw exponential gaps (Poisson arrivals)
at each phase's rate from one seeded ``random.Random``.
"""

from __future__ import annotations

import random

RAMP_PHASES = (("ramp_0.25x", 0.25), ("ramp_0.5x", 0.5), ("ramp_1x", 1.0), ("ramp_2x", 2.0))
DIURNAL_PHASES = (("diurnal_night", 0.2), ("diurnal_morning", 1.0), ("diurnal_peak", 1.8),
                  ("diurnal_evening", 0.8))
PROFILES = ("const", "ramp", "diurnal")


def arrival_schedule(profile: str, n: int, rate_rps: float, seed: int = 0) -> tuple[list[float], list[int], list[dict]]:
    """``(offsets_s, phase_of, phase_meta)`` for ``n`` requests: send
    offsets from the start (non-decreasing), each request's phase and each
    phase's name, target rate and request count."""
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if profile == "const":
        period = 1.0 / rate_rps
        return [i * period for i in range(n)], [0] * n, [{"phase": "const", "target_rps": rate_rps, "requests": n}]
    phases = RAMP_PHASES if profile == "ramp" else DIURNAL_PHASES
    per = [n // len(phases)] * len(phases)
    per[-1] += n - sum(per)
    rng = random.Random(f"load_gen/{profile}/{seed}")
    offsets: list[float] = []
    phase_of: list[int] = []
    meta: list[dict] = []
    t = 0.0
    for pi, ((name, mult), count) in enumerate(zip(phases, per)):
        rate = rate_rps * mult
        meta.append({"phase": name, "target_rps": round(rate, 3), "requests": count})
        for _ in range(count):
            offsets.append(t)
            phase_of.append(pi)
            t += rng.expovariate(rate)
    return offsets, phase_of, meta
