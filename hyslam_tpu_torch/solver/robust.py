"""Huber IRLS weight and the reference's chi-square gates (counterpart of
``hyslam_tpu/solver/robust.py``)."""

from __future__ import annotations

import torch

# copied from hyslam_tpu/solver/robust.py (Optimizer.cc:195-207)
CHI2_MONO = 5.991    # 95% quantile, 2 dof
CHI2_STEREO = 7.815  # 95% quantile, 3 dof


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Huber kernel as a function of the squared error
    chi2: 1 inside the basin, delta/sqrt(chi2) outside."""
    safe = torch.clamp_min(chi2, 1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / safe))


def huber_rho(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber cost rho(chi2), for total-cost comparisons."""
    d = torch.sqrt(torch.as_tensor(delta2, dtype=chi2.dtype, device=chi2.device))
    e = torch.sqrt(torch.clamp_min(chi2, 0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * d * e - delta2)
