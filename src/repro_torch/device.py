"""Device resolution for the port's entry points, and packed copies.

Entry points run on the card (``"cuda"``) unless the caller asks for the
CPU, as the CPU tests do. Asking for CUDA where there is no GPU raises:
nothing continues quietly on the CPU. :func:`to_device_packed` moves
several host arrays to the device in one copy, and :class:`PinnedStaging`
does so from pinned memory without blocking the host. :func:`constant`
keeps one copy of a small table on each device, so a loop that indexes it
copies nothing from the host.
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per (values,
    device, dtype). Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _layout(arrays) -> tuple[list[np.ndarray], list[int], int]:
    """The arrays made contiguous, their 16-byte aligned offsets in one
    packed byte buffer, and its size."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // 16) * 16
        offsets.append(total)
        total += a.nbytes
    return arrays, offsets, total


def _pack(arrays, offsets, buf: np.ndarray) -> None:
    for a, off in zip(arrays, offsets):
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)


def _views(packed: torch.Tensor, arrays, offsets) -> list[torch.Tensor]:
    return [
        packed[off:off + a.nbytes]
        .view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
        for a, off in zip(arrays, offsets)
    ]


def to_device_packed(arrays, device: torch.device | str) -> list[torch.Tensor]:
    """Copy numpy ``arrays`` to ``device`` in one host-to-device copy.

    The arrays are packed into one byte buffer, each at a 16-byte aligned
    offset, and come back as views of the one device buffer with their
    dtypes and shapes. On the CPU the views share the packed buffer."""
    arrays, offsets, total = _layout(arrays)
    buf = np.empty(total, np.uint8)
    _pack(arrays, offsets, buf)
    return _views(torch.as_tensor(buf).to(device), arrays, offsets)


class PinnedStaging:
    """A reusable pinned host buffer for asynchronous uploads.

    :meth:`to_device` packs numpy arrays into the buffer as
    :func:`to_device_packed` does and copies them to a CUDA device in one
    ``non_blocking`` copy on the current stream, so the copy neither
    blocks the host nor stages through a pageable bounce buffer. Before
    the buffer is written again, the host waits for the event recorded
    after the previous copy out of it: a copy still in flight is never
    overwritten."""

    def __init__(self):
        self._buf: torch.Tensor | None = None
        self._done = None        # torch.cuda.Event after the last copy

    def to_device(self, arrays, device: torch.device) -> list[torch.Tensor]:
        arrays, offsets, total = _layout(arrays)
        if self._done is not None:
            self._done.synchronize()
        if self._buf is None or self._buf.numel() < total:
            self._buf = torch.empty(max(total, 1), dtype=torch.uint8,
                                    pin_memory=True)
        host = self._buf[:total]
        _pack(arrays, offsets, host.numpy())
        packed = torch.empty(total, dtype=torch.uint8, device=device)
        packed.copy_(host, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record()
        return _views(packed, arrays, offsets)
