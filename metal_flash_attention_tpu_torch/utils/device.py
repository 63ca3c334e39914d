"""Where the port's constructors put their tensors.

The rule: an entry point runs on the card unless the caller asks for the
CPU.  ``device=None`` therefore means CUDA, never PyTorch's own default
(the CPU); on a machine without a card such a call raises instead of
quietly building CPU tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as
    given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to build CPU "
                           "tensors")
    return torch.device("cuda")
