"""Where the port runs.  Entry points run on the GPU unless the caller asks
for the CPU; with no GPU and no such request they raise, never falling back
quietly."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``cuda`` by default; ``"cpu"`` (or any torch device) when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """``v`` as ``dtype`` on ``device``: a tensor, of any shape, is moved (a
    no-op where it is there already); a Python or numpy number becomes a
    0-d fill on the device, which is no host-to-device copy, so a CUDA
    graph can hold it."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)
