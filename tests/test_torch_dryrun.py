"""The port's dry-run (``launch.count``, ``launch.roofline``,
``launch.dryrun``, ``launch.cell``) on the CPU, against the JAX
reference where it has a counterpart.

- ``model_flops`` and ``loop_factor`` equal the reference's bit for bit
  for every (arch, shape); ``roofline_terms`` at the reference's v5e
  constants (197e12, 819e9, 50e9) equals its dict for the same FLOPs,
  bytes and collective bytes.
- Each kernel wrapper on ``meta`` returns its outputs' shapes and charges
  the counter. Its FLOPs equal ``FlopCounterMode``'s count of its plain
  version on the CPU where the plain version's products are the kernel's
  (flash forward and backward, non-causal); where the kernel skips work
  (causal flash: the pairs with key <= query) or ``FlopCounterMode`` has
  no formula for the plain version's ops (the SpMM's ``index_add_``) the
  test states the formula; the bag and the window kernels charge bytes
  only, as their plain versions count no FLOPs.
- The counter counts a known sequence of products exactly, and the
  live-bytes peak of a small forward and backward equals a hand count.
- Every cell of the matrix builds on ``meta``, as the reference's
  ``TestCellBuilders`` builds every cell; the small ones count a step.
- The GraphSAGE cell's loss and one AdamW step agree with the reference's
  ``sage.apply_full`` cell at the smoke config (rtol 1e-5).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import threading

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import greendygnn_sage as rcfg_sage
from repro.configs import registry as rreg
from repro.launch import roofline as rrl
from repro_torch import convert
from repro_torch.configs import greendygnn_sage as pcfg_sage
from repro_torch.configs import registry as preg
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.segment_mm import ops as spmm_ops
from repro_torch.launch import cell as pcell
from repro_torch.launch import count
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as prl
from test_torch_gnn_models import (
    _adam_step_close,
    _reference_step,
    _smoke_arch,
    _tree_close,
)
from _jax_release import release_jax_executables  # noqa: F401

CELLS = tuple((a, s) for a in rreg.ARCHS for s in rreg.get_arch(a).shapes)
V5E = prl.CardPeaks("v5e", 819e9, 197e12, 197e12, link_bytes_per_s=50e9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_flops(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def _charged(fn, *args, **kw):
    """(the counter's summary, fn's result) of ``fn`` on meta tensors."""
    return count.count_call(fn, *args, **kw)


# ----------------------------------------------------------- roofline
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_model_flops_and_loop_factor_equal_the_reference(arch_id, shape):
    got = prl.model_flops(arch_id, shape)
    want = rrl.model_flops(arch_id, shape)
    assert got == want and type(got) is type(want)
    got, want = prl.loop_factor(arch_id, shape), rrl.loop_factor(arch_id,
                                                                 shape)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("flops,n_bytes,coll", [
    (3.1e15, 2.2e12, {"all-reduce": 4096.0}),
    (1.0e12, 5.0e12, {}),
    (0.0, 0.0, {}),
    (2.0e9, 1.0e6, {"all-gather": 8.0e9, "reduce-scatter": 2.0e9}),
])
def test_roofline_terms_equal_the_reference_at_v5e(flops, n_bytes, coll):
    hlo = "\n".join(
        f"  %c{i} = f32[{int(n) // 4}]{{0}} {kind}(f32[8]{{0}} %p)"
        for i, (kind, n) in enumerate(coll.items()))
    want = rrl.roofline_terms({"flops": flops, "bytes accessed": n_bytes},
                              hlo, 1.0)
    got = prl.roofline_terms({"bf16": flops}, n_bytes, coll, V5E,
                             reference_factor=7.0)
    assert {k: got[k] for k in want} == want
    assert got["reference_loop_factor"] == 7.0 and got["loop_factor"] == 1.0


def test_roofline_terms_sum_the_dtypes_at_their_peaks():
    h100 = prl.peaks_of("NVIDIA H100 80GB HBM3")
    t = prl.roofline_terms({"float32": 67e12, "bfloat16": 989e12}, 3.35e12,
                           None, h100)
    assert t["compute_s"] == pytest.approx(2.0) and t["memory_s"] == 1.0
    assert t["dominant"] == "compute" and t["collective_s"] == 0.0
    with pytest.raises(ValueError, match="link rate"):
        prl.roofline_terms({}, 1.0, {"all-reduce": 1.0}, h100)
    with pytest.raises(ValueError, match="no peak"):
        prl.roofline_terms({"int8": 1.0}, 1.0, None, h100)


# ------------------------------------------------------------- kernels
def _qkv(b, sq, sk, hq, hkv, d, dv, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, sq, hq, d), generator=g).to(dtype),
            torch.randn((b, sk, hkv, d), generator=g).to(dtype),
            torch.randn((b, sk, hkv, dv), generator=g).to(dtype))


@pytest.mark.parametrize("shape", [(1, 128, 128, 4, 2, 64, 64),
                                   (2, 64, 128, 4, 4, 32, 32),
                                   (1, 128, 128, 2, 1, 96, 64)])
def test_flash_charge_equals_the_plain_versions_count(shape):
    """Non-causal: the kernels compute every (query, key) pair, as the
    plain versions' products do."""
    q, k, v = _qkv(*shape)
    s, out = _charged(flash_ops.flash_attention, *count.to_meta((q, k, v)),
                      causal=False, block_q=64, block_k=64)
    want = _plain_flops(flash_ops.flash_attention_plain, q, k, v, False,
                        64, 64)
    assert s["kernels"]["flash_attention"]["calls"] == 1
    assert s["kernels"]["flash_attention"]["flops"] == want
    assert s["flops"] == want
    assert out.device.type == "meta"
    assert out.shape == flash_ops.flash_attention_plain(
        q, k, v, False, 64, 64).shape
    o, lse = flash_ops.flash_attention_plain(q, k, v, False, 64, 64,
                                             return_lse=True)
    do = torch.ones_like(o)
    s, grads = _charged(flash_ops.flash_attention_bwd,
                        *count.to_meta((q, k, v, o, do)), causal=False,
                        lse=count.to_meta(lse))
    want = _plain_flops(flash_ops.flash_attention_bwd_plain, q, k, v, o, do,
                        False, lse=lse)
    assert s["kernels"]["flash_attention_bwd"]["flops"] == want
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    b, sq, hq, d = q.shape
    dv, es = v.shape[-1], q.element_size()
    assert s["kernels"]["flash_attention_bwd"]["bytes"] == (
        (2 * (q.numel() + k.numel() + v.numel()) + 2 * o.numel()) * es
        + 4 * b * hq * sq)


@pytest.mark.parametrize("sq,sk", [(128, 128), (64, 192), (192, 64)])
def test_causal_flash_is_charged_the_pairs_key_le_query(sq, sk):
    """Stated formula: the kernels skip the tiles above the diagonal, so
    they are charged 2 (D + D_v) (forward) and 2 (3 D + 2 D_v) (backward)
    a q head and a pair (i, j) with j <= i, i < Sq, j < Sk."""
    q, k, v = count.to_meta(_qkv(1, sq, sk, 4, 2, 64, 64, torch.bfloat16))
    pairs = sum(min(i + 1, sk) for i in range(sq))
    assert flash_ops.causal_pairs(sq, sk, True) == pairs
    s, _ = _charged(flash_ops.flash_attention, q, k, v, causal=True,
                    block_q=64, block_k=64)
    assert s["flops_by_dtype"] == {"bfloat16": 2.0 * 128 * 4 * pairs}
    assert s["kernels"]["flash_attention"]["bytes"] == 2 * (
        q.numel() + k.numel() + v.numel() + q.numel())


def test_spmm_charge_states_its_formula():
    """``FlopCounterMode`` has no formula for the plain version's
    ``index_add_`` (it counts 0); the kernel is charged a multiply and an
    add an entry and a column, and its bytes."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 30, 300)
    rowptr, col, val = spmm_ops.to_csr(src, dst, 30, 40)
    fmt = spmm_ops.CsrFormat.from_numpy(rowptr, col, val, 40, "cpu")
    x = torch.randn(40, 24)
    assert _plain_flops(spmm_ops.csr_spmm, fmt, x) == 0
    s, y = _charged(spmm_ops.csr_spmm, *count.to_meta((fmt, x)))
    nnz = len(col)
    k = s["kernels"]["csr_spmm"]
    assert k["calls"] == 1 and k["flops"] == 2 * nnz * 24
    assert k["bytes"] == 4 * 31 + 8 * nnz + 4 * 24 * (40 + 30)
    assert y.shape == spmm_ops.csr_spmm(fmt, x).shape == (30, 24)


def test_bag_charge_is_bytes_only():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 50, 80).astype(np.int32)
    seg = np.sort(rng.integers(0, 20, 80)).astype(np.int32)
    fmt = bag_ops.BagFormat.from_numpy(idx, seg, 20, None, "cpu")
    table = torch.randn(50, 12)
    assert _plain_flops(bag_ops.bag_sum, fmt, table) == 0
    s, out = _charged(bag_ops.bag_sum, *count.to_meta((fmt, table)))
    assert s["flops"] == 0 and s["kernels"]["embedding_bag"]["calls"] == 1
    assert s["kernels"]["embedding_bag"]["bytes"] == 4 * (
        80 * (12 + 2) + 21 + 20 * 12)
    assert out.shape == (20, 12)
    s, out = _charged(bag_ops.embedding_bag, *count.to_meta(
        (table, torch.from_numpy(idx), torch.from_numpy(seg))), 20)
    assert out.shape == (20, 12) and s["kernels"]["embedding_bag"]["calls"]


def test_window_kernels_charge_their_operands_bytes():
    from test_torch_cluster_sim import _plain_operands
    from test_torch_queue_sim import _wrapper_inputs
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.kernels.queue_window import ops as qw

    for fn, args in ((qw.queue_window, _wrapper_inputs()),
                     (cw.cluster_window, _plain_operands())):
        name = fn.__name__
        assert _plain_flops(fn, *args) == 0
        want = fn(*args)
        s, got = _charged(fn, *count.to_meta(args))
        k = s["kernels"][name]
        assert k["calls"] == 1 and k["flops"] == 0 and s["flops"] == 0
        flat = [t for t in torch.utils._pytree.tree_flatten(
            dataclasses.astuple(got[1]))[0] if isinstance(t, torch.Tensor)]
        assert all(t.device.type == "meta" for t in flat)
        assert {n: tuple(t.shape) for n, t in got[0].items()} == {
            n: tuple(t.shape) for n, t in want[0].items()}
        assert k["bytes"] > 0


def test_a_charge_goes_to_the_launching_threads_counters_only():
    """A kernel another thread launches while a step is counted (the
    pipeline's builder) is not charged to the step's counter; one the
    counting thread launches is, to every counter active there."""
    mq, mk, mv = count.to_meta(_qkv(1, 128, 128, 4, 2, 64, 64))
    kw = dict(causal=False, block_q=64, block_k=64)
    outer, inner = count.Counter(), count.Counter()
    with outer:
        t = threading.Thread(target=flash_ops.flash_attention,
                             args=(mq, mk, mv), kwargs=kw)
        t.start()
        t.join()
        assert outer.summary()["kernels"] == {}
        with inner:
            flash_ops.flash_attention(mq, mk, mv, **kw)
    for c in (outer, inner):
        assert c.summary()["kernels"]["flash_attention"]["calls"] == 1


@pytest.mark.parametrize("sms,parts", [(None, 1), (1, 1), (4, 4), (132, 8)])
def test_meta_dkdv_split_takes_the_counters_card(sms, parts):
    """On meta the bf16 backward's dK/dV split is sized by the SMs of the
    card the counter prices; 2 CTAs (one KV head, two key tiles) of a
    head group of 8 double while below 2 a SM. No counter: 1 part."""
    q = torch.empty((1, 128, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 128, 1, 64), dtype=torch.bfloat16, device="meta")
    assert flash_ops.dkdv_split(q, k) == 1
    with count.Counter(sms=sms):
        assert flash_ops.dkdv_split(q, k) == parts


def test_the_kernels_import_nothing_of_the_launch_layer():
    root = pathlib.Path(flash_ops.__file__).resolve().parents[1]
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.startswith("repro_torch.launch")
                           for n in names), path


# ------------------------------------------------------------- counter
def test_counter_counts_a_known_sequence_of_products():
    x = torch.empty(64, 1024, device="meta")
    ws = [torch.empty(1024, 1024, device="meta") for _ in range(5)]
    c = count.Counter()
    with c:
        for w in ws:
            x @ w
        xb = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
        torch.bmm(xb[None], torch.empty(1, 16, 4, dtype=torch.bfloat16,
                                        device="meta"))
    s = c.summary()
    assert s["flops_by_dtype"] == {"float32": 671_088_640.0,
                                   "bfloat16": 2 * 8 * 16 * 4}
    # each product reads x and w once and writes its output once; the
    # bf16 operands' empty() writes nothing, their [None] is a view
    per_mm = 4 * (64 * 1024 + 1024 * 1024 + 64 * 1024)
    assert s["bytes"] == 5 * per_mm + 2 * (8 * 16 + 16 * 4 + 8 * 4)
    # mm x5, empty, unsqueeze, empty, bmm
    assert s["n_ops"] == 5 + 1 + 1 + 1 + 1
    assert count.Counter().summary()["flops"] == 0


def test_live_bytes_peak_of_a_forward_and_backward():
    """A hand count: w (256 x 256) and x (32 x 256) float32, live before
    the step; h = x @ w, r = relu(h), loss = r.sum(), then the gradient
    with respect to w: the loss's seed grad (4 B), relu's backward (32 x
    256), mm's backward for w (256 x 256). h dies only once the step's
    graph is gone."""
    w = torch.empty(256, 256, device="meta", requires_grad=True)
    x = torch.empty(32, 256, device="meta")
    c = count.Counter()
    c.track(w, x)
    with c:
        h = x @ w
        r = torch.relu(h)
        loss = r.sum()
        (g,) = torch.autograd.grad(loss, [w])
    args = 4 * (256 * 256 + 32 * 256)
    act = 4 * 32 * 256
    assert c.peak == args + act + act + 4 + 4 + act + 4 * 256 * 256
    del h, r, loss, g
    import gc

    gc.collect()
    assert c.live == args


def test_tracked_arguments_include_the_optimizer_state():
    """A train step's arguments hold the optimizer's moments inside an
    ``OptState`` dataclass: they are live from the start."""
    from repro_torch import optim

    params = {"w": torch.empty(64, 32, device="meta")}
    opt = optim.adamw(1e-3)
    state = opt.init(params)
    c = count.Counter()
    c.track(params, state)
    assert c.tracked == c.live == c.peak == 3 * 4 * 64 * 32


def test_counter_bytes_rules():
    a = torch.empty(16, 8, device="meta")
    b = torch.empty(8, device="meta")
    c = count.Counter()
    with c:
        a.add_(b)                   # reads a and b (broadcast once), writes a
    assert c.bytes == 4 * (128 + 8 + 128)
    c = count.Counter()
    with c:
        a.copy_(a.t().contiguous().t())   # contiguous copies; copy_ writes
    assert c.bytes == 4 * (128 + 128) + 4 * (128 + 128)
    c = count.Counter()
    with c:
        a.view(-1), a[2:], a.t(), a.split(4)
        torch.zeros_like(a)
    assert c.bytes == 4 * 128 and c.flops == {}
    table = torch.empty(1000, 8, device="meta")
    idx = torch.empty(5, dtype=torch.int64, device="meta")
    c = count.Counter()
    with c:
        rows = table[idx]                 # 5 rows gathered, not 1,000
        table.index_add_(0, idx, rows)    # 5 rows touched
    assert c.bytes == (8 * 5 + 2 * 4 * 40) + (8 * 5 + 4 * 40 + 2 * 4 * 40)


# ---------------------------------------------------------------- cells
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_every_cell_builds_on_meta(arch_id, shape):
    cell = pcell.build_cell(preg.get_arch(arch_id), shape, "meta")
    tensors = [t for t, _ in dryrun.leaves_with_axes(cell["args"],
                                                     cell["arg_axes"])]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert cell["kind"] in ("train_step", "serve_step")
    assert len(cell["args"]) == len(cell["arg_axes"])


@pytest.mark.parametrize("arch_id,shape", [
    ("greendygnn-sage", "molecule"), ("pna", "full_graph_sm"),
    ("fm", "serve_p99"), ("tinyllama-1.1b", "long_500k")])
def test_dryrun_record(arch_id, shape):
    rec = dryrun.run_cell(arch_id, shape, "meta", save=False)
    r = rec["roofline"]
    assert r["card"] == "NVIDIA H100 80GB HBM3"
    assert r["flops_per_device"] == rec["counted"]["flops"]
    assert r["bytes_per_device"] == rec["counted"]["bytes"] > 0
    assert r["loop_factor"] == 1.0
    assert r["reference_loop_factor"] == rrl.loop_factor(arch_id, shape)
    assert rec["memory"]["peak_live_bytes"] >= \
        rec["memory"]["argument_bytes_per_device"]
    single, multi = rec["sharded"]["single"], rec["sharded"]["multi"]
    assert single["n_devices"] == 256 and multi["n_devices"] == 512
    assert 0 < multi["argument_bytes_per_device"] <= \
        single["argument_bytes_per_device"] <= \
        rec["memory"]["argument_bytes_per_device"]
    assert (rec["model_flops_global"] is None) == (
        preg.get_arch(arch_id).family != "lm")


# ----------------------------------------------------------- the SAGE cell
@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_sage_cell_step_against_the_reference(shape):
    arch_p = _smoke_arch(pcfg_sage.ARCH, pcfg_sage.make_smoke_config())
    arch_r = _smoke_arch(rcfg_sage.ARCH, rcfg_sage.make_smoke_config())
    cell = pcell.build_gnn_cell(arch_p, shape, device="cpu", seed=0)
    params, opt_state, *inputs = cell["args"]
    args_np = ([convert.gnn_params_to_jax(params)]
               + [t.numpy() for t in inputs])
    r_params, r_opt, r_loss = _reference_step(arch_r, shape, args_np)
    new_params, new_opt, loss = cell["step_fn"](params, opt_state, *inputs)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    _tree_close(new_opt.mu, r_opt.mu, dict(rel=1e-5, abs=0.0))
    _adam_step_close(new_params, r_params, r_opt.mu)
    assert new_opt.step == int(r_opt.step) == 1
