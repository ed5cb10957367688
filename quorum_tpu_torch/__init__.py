"""PyTorch/CUDA port of quorum_tpu: the single-GPU `quorum` main path
(stage-1 build, in-process table handoff, stage-2 correction).

The package imports torch and numpy only. Its entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU; there the
hand-written kernels (quorum_tpu_torch/kernels) are replaced by their
plain PyTorch versions, because the tensors they are given lie on the
CPU. With the default device and no CUDA the entry points raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(name: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """The torch.device an entry point runs on. A CUDA device without a
    usable card raises instead of dropping to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass --device cpu (device='cpu') to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
