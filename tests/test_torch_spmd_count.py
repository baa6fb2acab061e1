"""The port's LM cells over the production meshes, on a fake process
group: the shards DTensor cuts, rank 0's argument shapes, and what the
counter sees of rank 0's program.

* At 2 x 2 x 2 (``("pod", "data", "model")``, the multi-pod rules), every
  rank's shard of every leaf of ``tests/_spmd_cases.py``'s two small LMs
  (parameters, tokens, cache; ``sharding.distribute_tree`` under
  ``launch.mesh.fake_world(8, rank)``) equals the reference's
  ``addressable_shards`` on 8 forced host devices, in content and in
  the mesh's device order.
* At 16 x 16 and 2 x 16 x 16, every LM cell's rank-0 argument shapes
  (``launch.cell.build_lm_cell(..., mesh=...)`` on ``meta``) equal the
  reference's ``NamedSharding(...).shard_shape`` of its own cell.
* On ``meta`` under ``fake_world(256)``, at 2 layers of a cell's widths:
  the counter's FLOPs are those of the local program as worked out by
  hand (TinyLlama's prefill); the collective bytes are positive and
  priced by ``roofline_terms`` at the card's link rate; and no
  redistribution gathers a vocabulary, a cache's sequence or an
  (E, C, D) dispatch tensor (every redistribution DTensor makes
  recorded; the collectives' kinds by ``CommDebugMode``: all-gathers,
  reduce-scatters and all-reduces only, no all-to-all).

The reference runs in a subprocess (it needs 512 host devices).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _spmd_cases as cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import count, dryrun, mesh as mesh_lib  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.cell import build_lm_cell  # noqa: E402
from repro_torch.models.lm import moe  # noqa: E402
from repro_torch.models.lm import transformer as tf  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
LM_ARCHS = [a for a in ARCHS if get_arch(a).family == "lm"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("shards") / "ref"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run = subprocess.run(
        [sys.executable, str(HERE / "_spmd_shards_reference.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return (dict(np.load(f"{out}.npz")),
            json.loads(pathlib.Path(f"{out}.json").read_text()))


def _paths(x, prefix=""):
    """(path, tensor) of a cell's arguments, keyed as the reference's
    ``tree_flatten_with_path`` (dict keys, tuple indices, dataclass
    fields); host ints (the optimizer's step, the cache length) are
    skipped, as the reference's 0-d leaves are."""
    if isinstance(x, torch.Tensor):
        yield prefix.rstrip("/"), x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _paths(v, f"{prefix}{i}/")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _paths(getattr(x, f.name), f"{prefix}{f.name}/")


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_every_rank_shard_equals_the_reference_at_2x2x2(reference, case):
    want = {k: v for k, v in reference[0].items()
            if k.startswith(case + "/")}
    cfg = cases.torch_config(case)
    data = cases.inputs(cases.CASES[case][0])
    trees = {
        "params": (convert.lm_params_from_jax(cases.numpy_params(
            cases.param_shapes(case))), tf.param_axes(cfg)),
        "tokens": (torch.from_numpy(data["tokens"]), ("batch", "seq")),
        "cache": ({k: torch.from_numpy(v) for k, v in data["cache"].items()},
                  tf.cache_specs(cfg))}
    names = mesh_lib.Mesh(("pod", "data", "model"), (2, 2, 2))
    got = {}
    for rank in range(names.size):
        with mesh_lib.fake_world(names.size, rank=rank):
            dmesh = mesh_lib.device_mesh(names, "cpu")
            rules = cases.rules_of(case, shlib.default_rules, multi=True)
            for name, (tree, axes) in trees.items():
                dist = shlib.distribute_tree(tree, axes, rules, dmesh)
                for path, t in cases.flat(dist).items():
                    key = f"{case}/{name}/{path}/{rank}".replace("//", "/")
                    got[key] = t.to_local().numpy()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_rank0_argument_shapes_equal_the_reference_shard_shapes(reference,
                                                                multi):
    names = mesh_lib.make_production_mesh(multi_pod=multi)
    n = 0
    with mesh_lib.fake_world(names.size):
        dmesh = mesh_lib.device_mesh(names, "cpu")
        for arch_id in LM_ARCHS:
            arch = get_arch(arch_id)
            for shape in arch.shapes:
                want = reference[1][f"{arch_id}/{shape}/"
                                    f"{'multi' if multi else 'single'}"]
                cell = build_lm_cell(arch, shape, "meta", mesh=dmesh)
                got = {p: list(t.to_local().shape)
                       for p, t in _paths(cell["args"])}
                assert got == want, (arch_id, shape)
                n += 1
    assert n == 20


def test_placements_follow_the_mesh_order():
    """A spec's axes in mesh order cut a dim major-to-minor (DTensor's
    outermost-first order); any other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    with mesh_lib.fake_world(8):
        dmesh = mesh_lib.device_mesh(
            mesh_lib.Mesh(("pod", "data", "model"), (2, 2, 2)), "cpu")
        assert shlib.placements_for((("pod", "data"), "model"), dmesh) == (
            Shard(0), Shard(0), Shard(1))
        assert shlib.placements_for((None,), dmesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            shlib.placements_for((("data", "pod"),), dmesh)
    assert not torch.distributed.is_initialized()


def test_fake_world_refuses_a_second_group_and_cleans_up():
    with mesh_lib.fake_world(4):
        with pytest.raises(RuntimeError, match="exists"):
            with mesh_lib.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()


def test_without_a_mesh_the_sites_are_the_identity():
    x = torch.ones(2, 3)
    with shlib.use_rules(shlib.default_rules(False),
                         mesh_lib.make_production_mesh()):
        assert shlib.shard_activation(x, ("batch", "embed")) is x
        assert shlib.gather_rows({"w": x})["w"] is x
        assert shlib.bind_rules(len) is len


# ------------------------------------------------------------- counting
def _count(arch_id: str, shape: str, layers: int = 2):
    """Rank 0's program of a cell over the 16 x 16 mesh at ``layers``
    layers of the arch's widths, counted on ``meta``: (config, summary,
    the kinds of collective ``CommDebugMode`` saw)."""
    from torch.distributed.tensor.debug import CommDebugMode

    arch = get_arch(arch_id)
    cfg = arch.make_config()
    cfg = dataclasses.replace(cfg, n_layers=layers)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    names = mesh_lib.make_production_mesh()
    with mesh_lib.fake_world(names.size):
        dmesh = mesh_lib.device_mesh(names, "cpu")
        cell = build_lm_cell(arch, shape, "meta", mesh=dmesh)
        with CommDebugMode() as comm:
            summary, _ = count.count_call(
                cell["step_fn"], *cell["args"],
                counter=count.Counter(sms=rl.peaks_of(dryrun.CARD).sms))
    kinds = {str(k).split(".")[-1] for k in comm.get_comm_counts()}
    return cfg, summary, kinds


@pytest.fixture
def redistributions(monkeypatch):
    """Every redistribution DTensor makes, explicit or inside an op's
    dispatch, as (global shape, placements before, placements after)."""
    from torch.distributed.tensor import _api, _dispatch, _redistribute

    seen = []
    inner = _redistribute.redistribute_local_tensor

    def recorded(local, current, target, **kwargs):
        seen.append((tuple(current.shape), tuple(current.placements),
                     tuple(target.placements)))
        return inner(local, current, target, **kwargs)

    for module in (_api, _dispatch, _redistribute):
        monkeypatch.setattr(module, "redistribute_local_tensor", recorded)
    return seen


def _unsharded(before, after) -> set:
    """The tensor dims a redistribution stops splitting on some mesh
    dim (a gather, or a partial sum's reduction, along them)."""
    return {p.dim for p, q in zip(before, after)
            if p.is_shard() and not (q.is_shard() and q.dim == p.dim)}


def test_tinyllama_prefill_flops_are_the_local_programs():
    """TinyLlama's ``prefill_32k`` at 2 layers, rank 0 of 16 x 16: 2 of
    the 32 sequences, 2 of the 32 q heads (and the one KV head they read
    of the 4 every device holds), 352 of the 5,632 FFN columns, 2,000 of
    the 32,000 vocabulary rows; the logits of the last position only."""
    cfg, s, kinds = _count("tinyllama-1.1b", "prefill_32k")
    b, seq, d = 2, 32768, cfg.d_model
    t = b * seq
    hq, hkv, dh, ff, v = 2, cfg.n_kv_heads, cfg.d_head, 352, 2000
    layer = (2 * t * d * hq * dh            # q
             + 2 * 2 * t * d * hkv * dh     # k, v (every KV head)
             + 2 * t * hq * dh * d          # wo
             + 3 * 2 * t * d * ff)          # gate, up, down
    flash = 2 * (dh + dh) * b * hq * seq * (seq + 1) // 2
    head = 2 * b * d * v
    assert s["flops_by_dtype"] == {
        "bfloat16": float(cfg.n_layers * (layer + flash) + head)}
    assert s["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert kinds <= {"all_gather_into_tensor", "all_reduce",
                     "reduce_scatter_tensor"}
    terms = rl.roofline_terms(s["flops_by_dtype"], s["bytes"],
                              s["collective_bytes"],
                              rl.mesh_peaks_of(dryrun.CARD))
    assert terms["collective_bytes_per_device"] > 0
    assert terms["collective_s"] == pytest.approx(
        sum(s["collective_bytes"].values()) / 450e9)


@pytest.mark.parametrize("arch_id,shape,held", [
    # the (B, S, V) logits and the vocabulary rows: V stays split
    ("tinyllama-1.1b", "train_4k", lambda shape: {
        d for d, n in enumerate(shape) if n == 32000}),
    # the cache split on cache_seq: its whole sequence is never gathered
    ("tinyllama-1.1b", "decode_32k", lambda shape: {
        d for d, n in enumerate(shape) if n == 32768}),
    # the (E, C, D) dispatch tensors, C = 49,152 of the 32 x 32,768
    # tokens: every split kept
    ("deepseek-v2-236b", "prefill_32k", lambda shape: set(range(3)) if (
        shape == (160, moe.capacity_of(32 * 32768, 160, 6, 1.25, False),
                  5120)) else set()),
])
def test_no_sharded_activation_is_silently_replicated(redistributions,
                                                      arch_id, shape, held):
    """No redistribution, explicit or one DTensor makes for an op it has
    no strategy for at the operands' placements, stops splitting a
    vocabulary, cache-sequence or dispatch-tensor dim; the collectives
    are all-gathers, reduce-scatters and all-reduces (no all-to-all,
    which a CPU mesh would run as an all-gather, so meta would not count
    what the card runs)."""
    cfg, s, kinds = _count(arch_id, shape)
    assert redistributions and sum(s["collective_bytes"].values()) > 0
    assert kinds <= {"all_gather_into_tensor", "all_reduce",
                     "reduce_scatter_tensor"}, kinds
    bad = [(sh, b, a) for sh, b, a in redistributions
           if _unsharded(b, a) & held(sh)]
    assert not bad, bad[:5]


def test_a_first_step_counts_as_a_second():
    """DTensor works out an op's global output shape once, on fake
    tensors, and caches it: the counter runs those ops without counting
    them, so a step counted with the cache cold equals one counted with
    it warm (and the card's count, taken after a timed step, equals
    meta's). qwen3's decode at 1 layer: op signatures no other test here
    has cached."""
    arch = get_arch("qwen3-1.7b")
    cfg = dataclasses.replace(arch.make_config(), n_layers=1)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    names = mesh_lib.make_production_mesh()
    with mesh_lib.fake_world(names.size):
        dmesh = mesh_lib.device_mesh(names, "cpu")
        cell = build_lm_cell(arch, "decode_32k", "meta", mesh=dmesh)
        counts = [count.Counter() for _ in range(2)]
        sums = [count.count_call(cell["step_fn"], *cell["args"],
                                 counter=c)[0] for c in counts]
    assert not counts[0].differences(counts[1])
    assert sums[0] == sums[1]


def test_an_uneven_dim_splits_as_torch_chunk():
    """Rank 0's shard of a dim that does not divide is the ceiling
    (``sharding.per_device_shape``); the last rank's the rest."""
    names = mesh_lib.Mesh(("data", "model"), (4, 2))
    t = torch.arange(30.0).reshape(10, 3)
    spec = ("data", None)
    for rank, rows in ((0, 3), (7, 1)):
        with mesh_lib.fake_world(names.size, rank=rank):
            dmesh = mesh_lib.device_mesh(names, "cpu")
            local = shlib.distribute_leaf(t, spec, dmesh).to_local()
        assert local.shape == (rows, 3)
        want = torch.chunk(t, 4)[rank // 2]
        assert torch.equal(local, want)
    assert shlib.per_device_shape((10, 3), spec, names) == (3, 3)
