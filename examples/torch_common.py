"""What the port's example drivers share: the name a result is recorded
under, and poses back to numpy."""

from __future__ import annotations

import subprocess

import torch


def device_record(dev: torch.device) -> dict:
    """``device``: the card's name (torch) or "cpu"; on a card also
    ``card``: its name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(dev),
            "card": out.stdout.strip().splitlines()[0] if out.returncode == 0 else None}


def pose_np(T: torch.Tensor):
    return T.detach().cpu().numpy()
