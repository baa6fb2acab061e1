from repro_torch.kernels.step_gate.ops import (  # noqa: F401
    StepGate,
    step_gate,
    step_gate_plain,
)
