"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; refuses CUDA when no card is present.

    Entry points default to "cuda" and never fall back to the CPU on
    their own: a caller that wants the CPU passes device="cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
