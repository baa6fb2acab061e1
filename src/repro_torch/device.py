"""Device resolution for the port's entry points, and packed copies.

Entry points run on the card (``"cuda"``) unless the caller asks for the
CPU, as the CPU tests do. Asking for CUDA where there is no GPU raises:
nothing continues quietly on the CPU. :func:`to_device_packed` moves
several host arrays to the device in one copy.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` -> ``torch.device``; raises when
    CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def to_device_packed(arrays, device: torch.device | str) -> list[torch.Tensor]:
    """Copy numpy ``arrays`` to ``device`` in one host-to-device copy.

    The arrays are packed into one byte buffer, each at a 16-byte aligned
    offset, and come back as views of the one device buffer with their
    dtypes and shapes. On the CPU the views share the packed buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // 16) * 16
        offsets.append(total)
        total += a.nbytes
    buf = np.empty(total, np.uint8)
    for a, off in zip(arrays, offsets):
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    packed = torch.as_tensor(buf).to(device)
    return [
        packed[off:off + a.nbytes]
        .view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
        for a, off in zip(arrays, offsets)
    ]
