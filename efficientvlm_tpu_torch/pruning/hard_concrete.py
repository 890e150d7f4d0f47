"""Hard-concrete (stretched binary concrete) gate distribution (port of
efficientvlm_tpu/pruning/hard_concrete.py).

Stretch limits (-0.1, 1.1), eps 1e-6, temperature 2/3 and the 'magical
number' 0.8 of the deterministic soft mask. Random draws take an explicit
torch.Generator; `deterministic_z` is host-side numpy, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LIMIT_A = -0.1
LIMIT_B = 1.1
EPS = 1e-6
MAGICAL_NUMBER = 0.8
LOGA_CLAMP_MIN = math.log(1e-2)
LOGA_CLAMP_MAX = math.log(1e2)


def _logit_x(x: float) -> float:
    xn = (x - LIMIT_A) / (LIMIT_B - LIMIT_A)
    return math.log(xn) - math.log(1 - xn)


def cdf_qz(x: float, loga: torch.Tensor, temperature: float = 2.0 / 3.0) -> torch.Tensor:
    """CDF of the stretched concrete at x, P(z <= x); 1 - cdf_qz(0, loga) is
    the per-gate keep probability."""
    return torch.sigmoid(_logit_x(x) * temperature - loga).clamp(EPS, 1 - EPS)


def quantile_concrete(u: torch.Tensor, loga: torch.Tensor,
                      temperature: float = 2.0 / 3.0) -> torch.Tensor:
    y = torch.sigmoid((torch.log(u) - torch.log(1 - u) + loga) / temperature)
    return y * (LIMIT_B - LIMIT_A) + LIMIT_A


def sample_z(generator: torch.Generator, loga: torch.Tensor,
             temperature: float = 2.0 / 3.0) -> torch.Tensor:
    """Stochastic gate sample, clipped to [0, 1] (the training path)."""
    u = torch.rand(loga.shape, generator=generator, device=loga.device) * (1 - 2 * EPS) + EPS
    return quantile_concrete(u, loga, temperature).clamp(0.0, 1.0)


def deterministic_z(loga, temperature: float = 2.0 / 3.0,
                    magical_number: float = MAGICAL_NUMBER) -> np.ndarray:
    """Deterministic eval mask of ONE layer row: the round(expected number of
    zeros) smallest soft-mask entries are 0, the rest exactly 1. Host-side:
    the count depends on the data."""
    loga = np.asarray(loga, np.float32)
    size = loga.shape[-1] if loga.ndim else 1
    keep_prob = 1.0 - np.clip(1.0 / (1.0 + np.exp(-(_logit_x(0.0) * temperature - loga))),
                              EPS, 1 - EPS)
    num_zeros = round(float(size - keep_prob.sum()))
    soft_mask = 1.0 / (1.0 + np.exp(-loga / temperature * magical_number))
    if num_zeros <= 0:
        return np.ones_like(soft_mask)
    if soft_mask.ndim == 0:
        return np.zeros_like(soft_mask)
    mask = np.ones_like(soft_mask)
    mask[np.argsort(soft_mask)[:num_zeros]] = 0.0  # smallest first
    return mask


def constrain_loga(loga: torch.Tensor) -> torch.Tensor:
    """Clamp log-alphas to [ln 1e-2, ln 1e2]."""
    return loga.clamp(LOGA_CLAMP_MIN, LOGA_CLAMP_MAX)


def init_loga(generator: torch.Generator, shape, droprate_init: float | None = None,
              mean: float | None = None, device=None) -> torch.Tensor:
    """Normal(mean, 0.01): mean 10 keeps every head gate, logit(1 -
    droprate) for the FFN gates."""
    if mean is None:
        droprate_init = droprate_init if droprate_init else 0.5
        mean = math.log(1 - droprate_init) - math.log(droprate_init)
    return mean + 0.01 * torch.randn(shape, generator=generator, device=device)
