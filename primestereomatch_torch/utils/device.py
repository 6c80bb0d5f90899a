"""Device choice for the entry points: the card unless the caller asks
for the CPU. There is no silent CPU path."""

from __future__ import annotations

import torch

_TABLES: dict = {}


def device_table(key: tuple, make, device: torch.device,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """The host table `make()` (an index or weight array that depends only
    on `key`) as a tensor on `device`, uploaded once per (key, device,
    dtype). A copy from pageable host memory synchronises the stream, so a
    table uploaded on every call would stall the host on the device."""
    k = (key, str(device), dtype)
    if k not in _TABLES:
        _TABLES[k] = torch.as_tensor(make(), dtype=dtype, device=device)
    return _TABLES[k]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the first CUDA card; raise if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
