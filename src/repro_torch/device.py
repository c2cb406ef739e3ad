"""Device resolution shared by every entry point of the port.

Entry points take ``device`` and default to CUDA.  Asking for CUDA on a
host without it raises; nothing falls back to the CPU silently.  Tests and
CPU-only callers pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without CUDA available raises.

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to evaluate on the CPU")
    return dev
