"""Speculation-length (gamma) selection from measured quantities (the
port's own copy of magicdec_tpu/engine/autotune.py, which it may not
import).

The reference publishes a hand-picked "Optimal gamma" per configuration,
found by offline sweeps.  This module derives it online from two cheap
measurements instead:

  alpha - per-position draft/target agreement probability, estimated from
          any short speculative run as the committed-tokens-per-window
          statistic;
  td/tv - per-draft-step and per-verify-step times
          (engine/profiling.time_phases, ``profile_decode``).

Under the standard i.i.d.-acceptance model (MagicDec paper section 4,
arXiv:2408.11049; also Leviathan et al. 2023 eq. 1), a window of gamma
draft steps commits

    E[tokens | gamma] = 1 + alpha + ... + alpha^gamma = (1 - a^(g+1)) / (1 - a)

tokens (the +1 is the verify bonus) and costs gamma * td + tv(gamma), so the
throughput-optimal gamma maximizes their ratio.  tv is taken as flat in
gamma (the verify pass streams the same weights and cache whatever its
window; the extra query rows ride that pass), so a scalar tv measured at
any small gamma serves.
"""

from __future__ import annotations

from typing import Iterable, Sequence


def expected_tokens_per_window(alpha: float, gamma: int) -> float:
    """E[committed tokens] for a gamma-step window under per-position
    acceptance probability alpha (includes the always-committed bonus/first
    token; range [1, gamma + 1])."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if gamma < 0:
        raise ValueError(f"gamma must be >= 0, got {gamma}")
    if alpha >= 1.0:
        return float(gamma + 1)
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def alpha_from_window_stats(tokens_per_window: float, gamma: int,
                            tol: float = 1e-6) -> float:
    """Invert expected_tokens_per_window: recover alpha from the measured
    committed-tokens-per-window average of a run at a known gamma (the
    engine's ``gen_tokens / target_steps / B``).  Bisection on [0, 1]."""
    t = float(tokens_per_window)
    if gamma <= 0 or t <= 1.0:
        return 0.0
    if t >= gamma + 1:
        return 1.0
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if expected_tokens_per_window(mid, gamma) < t:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def window_throughput(alpha: float, gamma: int, td: float, tv: float) -> float:
    """Committed tokens per unit of td/tv time for one request."""
    if td <= 0 or tv <= 0:
        raise ValueError("td/tv must be positive")
    return expected_tokens_per_window(alpha, gamma) / (gamma * td + tv)


def pick_gamma(alpha: float, td: float, tv: float,
               candidates: Sequence[int] = (1, 2, 3, 4, 5, 6, 8)) -> int:
    """Throughput-argmax gamma.  td = draft step time, tv = verify step time
    (any consistent unit).  With alpha -> 1 and td << tv it picks the
    largest candidate; with alpha -> 0 or td >= tv the smallest."""
    if not candidates:
        raise ValueError("no gamma candidates")
    return max(candidates, key=lambda g: window_throughput(alpha, g, td, tv))


def pick_gamma_from_run(tokens_per_window: float, gamma_run: int,
                        td: float, tv: float,
                        candidates: Iterable[int] = (1, 2, 3, 4, 5, 6, 8)) -> int:
    """One-shot autotune: observe a run at gamma_run, re-pick gamma."""
    alpha = alpha_from_window_stats(tokens_per_window, gamma_run)
    return pick_gamma(alpha, td, tv, tuple(candidates))
