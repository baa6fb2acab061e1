"""The port's checkpoints against the reference's, on the CPU.

Both packages save the same ``(params, OptState)`` tree; every file, the
manifest included, must be byte-equal, and each package must restore the
other's checkpoint exactly. The reference writes its manifest with
``msgpack`` (which this test imports); the port writes it with its own
codec, since the card's machine has no ``msgpack``. bf16: the port reads
a reference-written bf16 leaf back bit for bit, where the reference's own
restore raises ``ValueError`` (a fault of the reference, which stays as
it is; the port's restore is a stated divergence).
"""
import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.train import checkpoint as rck
from repro_torch import optim as poptim
from repro_torch.train import checkpoint as pck
from _jax_release import release_jax_executables  # noqa: F401


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 4, 3)).astype(np.float32),
                       "ln": np.ones((2, 4), np.float32)},
            "count": np.arange(5, dtype=np.int32)}


def _trees(seed=0, steps=2):
    """The same (params, OptState) after ``steps`` AdamW updates of the
    same gradients, in each package."""
    arrays = _arrays(seed)
    pp = _to_torch(arrays)
    rp = jax.tree.map(jnp.asarray, arrays)
    popt, ropt = poptim.adamw(1e-2), roptim.adamw(1e-2)
    float_keys = ("embed", "layers")
    ps = popt.init({k: pp[k] for k in float_keys})
    rs = ropt.init({k: rp[k] for k in float_keys})
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        g = {k: _arrays(int(rng.integers(1 << 30)))[k] for k in float_keys}
        _, ps = popt.update(_to_torch(g), ps, {k: pp[k] for k in float_keys})
        _, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs,
                            {k: rp[k] for k in float_keys})
    return (pp, ps), (rp, rs)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(tree)


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def _assert_same(port_tree, ref_tree):
    flat_p, flat_r = pck._flatten(port_tree), rck._flatten(ref_tree)
    assert list(flat_p) == list(flat_r)
    for key, want in flat_r.items():
        got = flat_p[key]
        if isinstance(got, int):
            assert got == int(want), key
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=key)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), key


def test_keys_are_the_reference_keys():
    pt, rt = _trees(0, 0)
    assert list(pck._flatten(pt)) == list(rck._flatten(rt))
    assert list(pck._flatten(pt))[:5] == [
        "0/count", "0/embed", "0/layers/ln", "0/layers/wq", "1/.step"]


def test_files_and_manifest_are_byte_equal(tmp_path):
    pt, rt = _trees()
    pck.save_checkpoint(str(tmp_path / "p"), 7, pt)
    rck.save_checkpoint(str(tmp_path / "r"), 7, rt)
    got = _files(tmp_path / "p" / "step_0000000007")
    want = _files(tmp_path / "r" / "step_0000000007")
    assert got.keys() == want.keys()
    assert "1__.step.npy" in got and pck.MANIFEST in got
    for name in want:
        assert got[name] == want[name], name
    meta = msgpack.unpackb(got[pck.MANIFEST])
    assert meta["step"] == 7 and meta["leaves"]["1/.step"]["dtype"] == "int32"


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32, -1, -32,
    -33, -128, -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1, "", "x" * 31,
    "x" * 32, "x" * 255, "x" * 256, "é" * 40, [], list(range(15)),
    list(range(16)), {"k": [1, "a"]}, {str(i): i for i in range(16)},
], ids=repr)
def test_manifest_codec_matches_msgpack(value):
    data = pck._pack(value)
    assert data == msgpack.packb(value)
    assert pck._unpack(data) == msgpack.unpackb(data)


@pytest.mark.parametrize("value", [True, None, 1.5, b"x"], ids=repr)
def test_manifest_codec_refuses_what_a_manifest_never_holds(value):
    with pytest.raises(TypeError):
        pck._pack(value)
    with pytest.raises(ValueError, match="msgpack type"):
        pck._unpack(msgpack.packb(value))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_restore_across(tmp_path, direction):
    pt, rt = _trees(seed=3)
    fresh_p, fresh_r = _trees(seed=4)
    if direction == "ref_to_port":
        rck.save_checkpoint(str(tmp_path), 5, rt)
        tree, step = pck.restore_checkpoint(str(tmp_path), fresh_p)
        assert step == 5
        _assert_same(tree, rt)
        assert isinstance(tree[1], poptim.OptState) and tree[1].step == 2
    else:
        pck.save_checkpoint(str(tmp_path), 5, pt)
        tree, step = rck.restore_checkpoint(str(tmp_path), fresh_r)
        assert step == 5
        _assert_same(pt, tree)


def test_restore_lands_on_the_target_dtype_and_device(tmp_path):
    pt, _ = _trees()
    pck.save_checkpoint(str(tmp_path), 1, pt)
    target = (dict(pt[0], embed=pt[0]["embed"].double()), pt[1])
    tree, _ = pck.restore_checkpoint(str(tmp_path), target)
    assert tree[0]["embed"].dtype == torch.float64
    assert tree[0]["embed"].device == torch.device("cpu")
    torch.testing.assert_close(tree[0]["embed"].float(), pt[0]["embed"],
                               rtol=0, atol=0)


def _bf16_pair(seed=5):
    x = np.random.default_rng(seed).standard_normal((3, 5)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)


def test_reference_bf16_leaf_restores_in_the_port_bit_for_bit(tmp_path):
    ref, port = _bf16_pair()
    rck.save_checkpoint(str(tmp_path), 1, {"w": ref})
    tree, _ = pck.restore_checkpoint(
        str(tmp_path), {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
    assert tree["w"].dtype == torch.bfloat16
    assert np.array_equal(tree["w"].view(torch.int16).numpy(),
                          np.asarray(ref).view(np.int16))
    assert torch.equal(tree["w"], port)
    # the reference's own restore of its bf16 leaf raises (its fault)
    with pytest.raises(ValueError, match="No cast function"):
        rck.restore_checkpoint(str(tmp_path), {"w": ref})


def test_port_bf16_leaf_is_byte_equal_and_round_trips(tmp_path):
    ref, port = _bf16_pair(6)
    pck.save_checkpoint(str(tmp_path / "p"), 2, {"w": port})
    rck.save_checkpoint(str(tmp_path / "r"), 2, {"w": ref})
    got = _files(tmp_path / "p" / "step_0000000002")
    assert got == _files(tmp_path / "r" / "step_0000000002")
    tree, _ = pck.restore_checkpoint(str(tmp_path / "p"),
                                     {"w": torch.zeros_like(port)})
    assert torch.equal(tree["w"], port)


def test_keep_last_k(tmp_path):
    pt, _ = _trees(steps=0)
    for step in range(1, 6):
        pck.save_checkpoint(str(tmp_path), step, pt, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004",
                                            "step_0000000005"]
    assert pck.latest_step(str(tmp_path)) == 5


def test_leftover_tmp_and_unpublished_dirs_are_ignored(tmp_path):
    pt, _ = _trees(steps=0)
    pck.save_checkpoint(str(tmp_path), 3, pt)
    os.makedirs(tmp_path / "step_0000000009.tmp")
    os.makedirs(tmp_path / "step_0000000008")   # no manifest
    assert pck.latest_step(str(tmp_path)) == 3
    assert pck.latest_step(str(tmp_path / "missing")) is None
    _, step = pck.restore_checkpoint(str(tmp_path), pt)
    assert step == 3


def test_async_writes_and_wait(tmp_path):
    pt, _ = _trees(steps=1)
    paths = [pck.save_checkpoint(str(tmp_path), s, pt, keep=5,
                                 blocking=False) for s in (1, 2, 3)]
    pck.wait_async()
    assert not any(t.name == "checkpoint-writer" and t.is_alive()
                   for t in threading.enumerate())
    assert all(os.path.isdir(p) for p in paths)
    assert pck.latest_step(str(tmp_path)) == 3
    tree, step = pck.restore_checkpoint(str(tmp_path), pt, step=2)
    assert step == 2
    for a, b in zip(pck._flatten(tree).values(), pck._flatten(pt).values()):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


def test_async_write_copies_the_leaves_before_returning(tmp_path):
    w = torch.ones(4)
    pck.save_checkpoint(str(tmp_path), 1, {"w": w}, blocking=False)
    w.add_(1.0)   # the caller goes on updating in place
    pck.wait_async()
    tree, _ = pck.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    assert torch.equal(tree["w"], torch.ones(4))


def test_mismatches_raise(tmp_path):
    pt, _ = _trees(steps=0)
    with pytest.raises(FileNotFoundError):
        pck.restore_checkpoint(str(tmp_path), pt)
    pck.save_checkpoint(str(tmp_path), 1, pt)
    extra = (dict(pt[0], more=torch.zeros(2)), pt[1])
    with pytest.raises(ValueError, match="tree mismatch"):
        pck.restore_checkpoint(str(tmp_path), extra)
    fewer = ({k: v for k, v in pt[0].items() if k != "count"}, pt[1])
    with pytest.raises(ValueError, match="tree mismatch"):
        pck.restore_checkpoint(str(tmp_path), fewer)
    shape = (dict(pt[0], embed=torch.zeros(6, 5)), pt[1])
    with pytest.raises(ValueError, match="shape"):
        pck.restore_checkpoint(str(tmp_path), shape)
