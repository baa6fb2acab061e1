"""The measured step's gate (``kernels/step_gate``) on the CPU.

On the card ``ComputeEngine.step`` enqueues its step behind a closed
gate, a kernel that holds the stream until the host opens it, so that
its CUDA events time device work only. The CPU has no stream to hold:
the step is timed with ``time.perf_counter`` and never touches a gate,
and a measured run's losses are those of a run with the gate removed.
The gate itself is held on the card by ``chip_smoke.phase_step_gate``
and the deployment check; here its plain version, its wrapper's
refusals and its C entry's signature.
"""
from __future__ import annotations

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.step_gate import ops as gate_ops
from repro_torch.store import MemoryBudget
from repro_torch.train import compute as pcomp
from repro_torch.train import gnn_trainer as pgt


def _words(flag: int) -> torch.Tensor:
    w = torch.zeros(2, dtype=torch.int32)
    w[gate_ops.FLAG] = flag
    return w


@pytest.mark.parametrize("flag,token,want", [(5, 5, 5), (0, 5, -5),
                                             (4, 5, -5), (2**30, 2**30,
                                                          2**30)])
def test_plain_gate_delivers_the_token_only_when_open(flag, token, want):
    words = _words(flag)
    gate_ops.step_gate(words, token, "cpu")
    assert int(words[gate_ops.STATUS]) == want
    assert int(words[gate_ops.FLAG]) == flag


def test_gate_refusals():
    with pytest.raises(ValueError, match="two int32"):
        gate_ops.step_gate(torch.zeros(2, dtype=torch.int64), 1, "cpu")
    with pytest.raises(ValueError, match="two int32"):
        gate_ops.step_gate(torch.zeros(3, dtype=torch.int32), 1, "cpu")
    with pytest.raises(ValueError, match="positive"):
        gate_ops.step_gate(_words(0), 0, "cpu")
    # a CUDA gate reads its words over the bus: pageable words are refused
    # before anything is built or launched
    with pytest.raises(ValueError, match="pinned"):
        gate_ops.step_gate(_words(1), 1, "cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        gate_ops.step_gate(_words(1), 1, "meta")


def test_step_gate_tokens_advance_and_check():
    gate = gate_ops.StepGate("cpu")
    gate.close()                       # the CPU's plain gate: still closed
    with pytest.raises(RuntimeError, match="not opened"):
        gate.check()
    first = gate.token
    gate.open()
    gate.close()                       # a new token: the old flag is stale
    assert gate.token == first + 1
    with pytest.raises(RuntimeError, match="not opened"):
        gate.check()


def test_entry_argtypes_match_the_c_signature():
    stem, argtypes = _build.ENTRIES["step_gate_wait"]
    text = (_build.CSRC / f"{stem}.cu").read_text()
    body = re.search(r'extern "C" int step_gate_wait\((.*?)\)\s*{', text,
                     re.S).group(1)
    kinds = tuple(_build._P if "*" in a else
                  _build._L if " ".join(a.split()).startswith("long long")
                  else _build._I for a in body.split(","))
    assert kinds == tuple(argtypes)
    assert stem not in _build.EXTRA_FLAGS


def _measured_run(monkeypatch, gate_cls):
    monkeypatch.setattr(pcomp, "StepGate", gate_cls)
    cfg = pgt.RunConfig(method="static_w", batch_size=600, n_epochs=2,
                        warmup_epochs=1, steps_per_epoch=4,
                        dataset="reddit", compute="measured", seed=0,
                        mem_budget=MemoryBudget(device_payloads=True),
                        device="cpu")
    return pgt.run(cfg, pgt.build_trace(cfg)).compute_report


def test_cpu_measured_step_is_timed_without_a_gate(monkeypatch):
    made = []

    class Recording(gate_ops.StepGate):
        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("the CPU step made a gate")

    with_gate = _measured_run(monkeypatch, Recording)
    without = _measured_run(monkeypatch, Refused)
    assert made == []
    assert with_gate["losses"] == without["losses"]
    assert with_gate["step_edges"] == without["step_edges"]
    assert len(with_gate["step_s"]) == with_gate["n_steps"] == 8
    assert all(t > 0 for t in with_gate["step_s"] + without["step_s"])
