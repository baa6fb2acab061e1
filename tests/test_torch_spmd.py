"""The port's LM step over a mesh, held against its one-device step and
the reference's sharded ``jit`` step.

Two small LMs (``tests/_spmd_cases.py``: GQA at TinyLlama's rules, MLA
with MoE at deepseek-v2's; 2 layers, float32, flash at S >= 16, remat)
run on a (2, 2) ``("data", "model")`` mesh with real collectives: the
port's sharded programs in 4 gloo processes, the reference's ``jit``
programs on 4 forced host devices, each in a subprocess of its own (the
two run at once), from the same seeded numpy parameters and inputs. The
port's one-device step runs here on the same inputs.

Compared: one ``train_4k``-style step (the loss; the parameters and
AdamW's first moments after it, lr 1e-2) and one decode step over the
case's cache (the logits and the written cache). Tolerances are
``tests/test_torch_lm_train.py``'s for the one-device step: the loss
rtol 1e-5; the first moments (the clipped gradients, times 0.1) atol
1e-5 / rtol 1e-4, as its gradients; the parameters after AdamW atol
1e-4. AdamW's first step moves an element by lr * g / (|g| + eps), so an
element whose gradient is within a few eps (1e-8) of zero moves by an
amount its float32 noise decides (the port's one-device step and the
reference's differ by 1.7e-4 at one such element of MLA's ``wo``, whose
gradient is 3e-8): where 0 < |g| < 1e-6 (under 1% of a leaf) an
element is held within the update's bound, 2 lr, and its gradient by
the first moments' tolerance.
The decode logits and the written cache atol 1e-5 / rtol 1e-5.
The sharded programs sum in other orders (partial products reduced
across the mesh; GQA's microbatches take each device's local rows where
the reference reshapes the global batch, ``launch/train.py``), so none
of these is bitwise.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _spmd_cases as cases  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.lm import transformer as tf  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
LOSS = dict(rtol=1e-5, atol=0.0)
STEP_PARAMS = dict(atol=1e-4, rtol=0.0)
GRADS = dict(atol=1e-5, rtol=1e-4)
LOGITS = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's sharded results and the reference's, from their two
    subprocesses, run side by side."""
    out = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    port = subprocess.Popen(
        [sys.executable, str(HERE / "_spmd_cases.py"), str(out / "port.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_spmd_reference.py"),
         str(out / "ref.npz")],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = [p.communicate(timeout=240)[0] for p in (port, ref)]
    assert port.returncode == 0, logs[0][-3000:]
    assert ref.returncode == 0, logs[1][-3000:]
    got = dict(np.load(out / "port.npz"))
    for r in range(4):
        got.update({f"coll/{r}/{k}": v for k, v in np.load(
            out / f"port.npz.rank{r}.npz").items()})
    return got, dict(np.load(out / "ref.npz"))


def _one_device(case: str) -> dict:
    """The port's one-device train and decode steps on the case's
    inputs, keyed as the sharded results."""
    torch.manual_seed(0)
    cfg = cases.torch_config(case)
    data = cases.inputs(cases.CASES[case][0])
    params = convert.lm_params_from_jax(
        cases.numpy_params(cases.param_shapes(case)))
    opt = optim.adamw(cases.LR, weight_decay=0.1, max_grad_norm=1.0)
    step = make_train_step(cfg, opt, cfg.grad_accum)
    new, state, loss = step(params, opt.init(params),
                            torch.from_numpy(data["tokens"]),
                            torch.from_numpy(data["targets"]))
    out = {f"{case}/loss": loss.numpy()}
    out.update({f"{case}/param/{k}": v.detach().numpy()
                for k, v in cases.flat(new).items()})
    out.update({f"{case}/mu/{k}": v.numpy()
                for k, v in cases.flat(state.mu).items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in data["cache"].items()}
    logits, cache = tf.decode_step(params, cfg,
                                   torch.from_numpy(data["token"]), cache,
                                   cases.DECODE_LEN)
    out[f"{case}/logits"] = logits.numpy()
    out.update({f"{case}/cache/{k}": v.numpy() for k, v in cache.items()})
    return out


@pytest.fixture(scope="module")
def one_device():
    return {case: _one_device(case) for case in cases.CASES}


def _held(got: dict, want: dict, case: str, what: str, tol: dict) -> int:
    keys = sorted(k for k in want if k.startswith(f"{case}/{what}"))
    assert keys and set(keys) <= set(got), (case, what)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    return len(keys)


def _compare(got: dict, want: dict, case: str) -> None:
    _held(got, want, case, "loss", LOSS)
    _held(got, want, case, "mu/", GRADS)
    keys = sorted(k for k in want if k.startswith(f"{case}/param/"))
    assert len(keys) == len(cases.flat(cases.param_shapes(case)))
    for k in keys:
        grad = np.abs(want[k.replace("/param/", "/mu/")]) / 0.1
        # within a few of AdamW's eps (an unreached row's 0 is exact)
        small = (grad > 0) & (grad < 1e-6)
        assert small.mean() < 1e-2, k
        np.testing.assert_allclose(got[k][~small], want[k][~small],
                                   err_msg=k, **STEP_PARAMS)
        np.testing.assert_allclose(got[k][small], want[k][small],
                                   err_msg=k, rtol=0, atol=2 * cases.LR)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_sharded_train_step_equals_the_one_device_step(runs, one_device,
                                                       case):
    _compare(runs[0], one_device[case], case)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_sharded_train_step_equals_the_reference_jit_step(runs, case):
    _compare(runs[0], runs[1], case)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_sharded_decode_step_equals_the_one_device_step(runs, one_device,
                                                        case):
    _held(runs[0], one_device[case], case, "logits", LOGITS)
    _held(runs[0], one_device[case], case, "cache/", LOGITS)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_sharded_decode_step_equals_the_reference_jit_step(runs, case):
    _held(runs[0], runs[1], case, "logits", LOGITS)
    _held(runs[0], runs[1], case, "cache/", LOGITS)


def test_the_cases_split_heads_and_kv_heads_as_the_rules_say():
    """GQA: each model device holds 2 of the 4 q heads and reads one of
    the 2 replicated KV heads (``attention.over_heads``' slicing); MLA's
    latent and MoE's 4 experts are split over ``model``."""
    gqa, mla = (cases.CASES[c] for c in ("gqa", "mla"))
    assert gqa[0]["n_heads"] // 2 == 2 and gqa[1]["kv_heads"] is None
    assert gqa[0]["n_heads"] // gqa[0]["n_kv_heads"] == 2
    assert mla[1]["kv_lora"] == "model" and mla[0]["n_experts"] % 2 == 0
    assert cases.ACCUM["gqa"] > 1


@pytest.mark.parametrize("name", cases.COLLECTIVES)
@pytest.mark.parametrize("dim", [0, 1], ids=["data", "model"])
def test_collective_helpers_over_a_mesh_dim_equal_the_reference(runs, name,
                                                                dim):
    """``distributed.collectives``' DeviceMesh forms, each rank with its
    own tree, against the reference's helpers under ``vmap`` over the
    ranks that share the mesh dim (``tests/test_torch_mesh.py``'s
    host-list cases): every rank's every leaf, atol 1e-6 (a sum of 2
    float32 values in either order is the same; the mean divides)."""
    got, want = runs
    keys = [k for k in want if k.startswith("coll/")
            and k.split("/")[2:4] == [str(dim), name]]
    assert len(keys) == 4 * (1 if name == "all_gather_rows" else 3)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
