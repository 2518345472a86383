"""Device resolution shared by every entry point of the port, and what the
kernel launch plans read of a CUDA device."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: without one this raises rather than silently
    running the plain PyTorch versions on the CPU.  Tests and CPU users
    pass ``device="cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device ``device`` (a tensor's
    device, which names its index), read once per device index."""
    return _sm_count(torch.device(device).index or 0)
