"""A stream gate that holds a CUDA stream until the host opens it, so that
an event pair times only device work that was all enqueued before it ran.

``csrc/step_gate.cu`` has no TPU counterpart: the reference times its
measured step as one compiled executable
(``repro/train/compute.py:303-307``), in which no Python runs, while the
port's step is ~100 eager launches, and an event pair around them also
times a host stall while they are enqueued. :class:`StepGate` closes the
gate (one launch of the kernel, which spins on a word of pinned host
memory), the caller records its start event, enqueues the step and its
end event, and then opens the gate (a host write to that word). Nothing
may wait on the stream between ``close`` and ``open``: the kernel gives up
after ``timeout_s`` and :meth:`StepGate.check` then raises. Besides a
pageable copy or ``.item()``, the caching allocator can wait there
unasked: when a step's allocation finds no cached block and
``cudaMalloc`` fails, it frees its cached blocks with ``cudaFree``, which
synchronizes the device. The step then stalls for the full timeout. A
caller keeps that rare by running each new shape once untimed first (its
blocks are then cached), and ``check``'s error names the cause.

:func:`step_gate` is the wrapper: on a CUDA device it launches the kernel
on the current stream (counted in ``step_gate.launches``); on the CPU it
takes :func:`step_gate_plain`, which delivers the token at once where the
gate is open (the CPU runs in program order: there is nothing to hold).
Bound: 8 bytes, the flag read and the status written once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TIMEOUT_S = 10.0     # a gate left closed gives up after this long
FLAG, STATUS = 0, 1  # the two int32 words: the host's token, the result


def step_gate_plain(words: torch.Tensor, token: int) -> None:
    """The gate's result with no time to wait: ``words[STATUS]`` is the
    token where ``words[FLAG]`` holds it (the gate is open), else minus
    the token (a timeout)."""
    words[STATUS] = token if int(words[FLAG]) == token else -token


def step_gate(words: torch.Tensor, token: int, device,
              timeout_s: float = TIMEOUT_S) -> None:
    """Hold ``device``'s current stream until ``words[FLAG]`` holds
    ``token`` (> 0), then write ``token`` to ``words[STATUS]`` (``-token``
    after ``timeout_s``). ``words``: two int32 in pinned host memory for a
    CUDA device (the kernel reads them over the bus), any host tensor for
    the CPU."""
    if words.dtype != torch.int32 or tuple(words.shape) != (2,) \
            or words.device.type != "cpu":
        raise ValueError("step_gate: words must be two int32 on the host")
    if token <= 0:
        raise ValueError("step_gate: the token must be positive")
    device = torch.device(device)
    if device.type == "cpu":
        step_gate_plain(words, token)
        return
    if device.type != "cuda":
        raise ValueError(f"step_gate: unsupported device {device}")
    if not words.is_pinned():
        raise ValueError("step_gate: words must be in pinned memory")
    fn = _build.entry("step_gate_wait")
    ptr = words.data_ptr()
    err = fn(ptr + 4 * FLAG, ptr + 4 * STATUS, int(token),
             int(timeout_s * 1e9),
             torch.cuda.current_stream(device).cuda_stream)
    _build.count_launch(step_gate)
    _build.check("step_gate_wait", err)


step_gate.launches = 0
step_gate.launches_by_thread = {}


class StepGate:
    """One gate for one device's current stream, reused step after step;
    each :meth:`close` takes a new token, so a word left open by an
    earlier step never opens a later gate."""

    def __init__(self, device, timeout_s: float = TIMEOUT_S):
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.words = torch.zeros(2, dtype=torch.int32,
                                 pin_memory=self.device.type == "cuda")
        self._view = self.words.numpy()   # host writes, no CUDA call
        self.token = 0

    def close(self) -> None:
        """Launch the gate on the current stream, closed."""
        self.token = self.token % (2**30) + 1
        self._view[STATUS] = 0
        step_gate(self.words, self.token, self.device, self.timeout_s)

    def open(self) -> None:
        """Let the stream run on past the gate."""
        self._view[FLAG] = self.token

    def check(self) -> None:
        """Raise unless the last gate was opened in time; call it after
        the stream has passed the gate (an event after it synchronized)."""
        status = int(self._view[STATUS])
        if status != self.token:
            raise RuntimeError(
                f"step_gate: the gate was not opened within "
                f"{self.timeout_s} s (status {status}, token {self.token}): "
                "something waited on the stream while it was closed (a "
                "pageable copy, .item(), or the caching allocator freeing "
                "its blocks under memory pressure)")
