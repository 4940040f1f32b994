"""Where the port's entry points put their tensors.

Scene factories and ``Film.create``/``Film.load_state`` take
``device=None``, which means the CUDA card.  The CPU is used only when
the caller asks for it (``device="cpu"``), as the CPU tests do; without
a card and without that request they raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> the current CUDA device (raises without one); anything
    else -> torch.device(device)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: mrt_torch builds on the card by "
                           "default; pass device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
