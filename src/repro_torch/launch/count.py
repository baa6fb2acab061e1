"""A one-card FLOP, byte and memory counter: the port's dry-run.

The reference proves its cells on a device mesh by lowering and compiling
them (``repro/launch/dryrun.py``) and reading XLA's ``cost_analysis`` and
``memory_analysis``. The port counts one step as it runs, on the card or
on the ``meta`` device (shapes only, nothing allocated):

* **Bytes.** :class:`Counter` is a ``TorchDispatchMode``: every ATen op on
  a device tensor (not a host scalar) adds the bytes of its tensor inputs,
  each read once, and of its outputs, each written once, as the
  roofline bound (``launch/roofline.py``) counts them. A view moves nothing
  (0 bytes); a factory that writes nothing (``empty``) neither; an input
  the op overwrites without reading (``copy_``, ``fill_``, ``zero_``) is
  counted as written only; a broadcast (stride-0) dim is read once. A
  gather (``index``, ``index_select``, ``embedding``, ``gather``) reads
  only the elements it gathers, and an in-place scatter (``index_add_``,
  ``index_put_``, ``scatter_add_``, ...) reads and writes only the
  elements its source touches, besides its indices.
* **FLOPs** of the matrix-class ops (``mm``, ``bmm``, ``addmm``,
  convolutions, SDPA, ...), by the formulas of
  ``torch.utils.flop_counter.FlopCounterMode`` (its ``flop_registry``),
  kept apart by the first operand's dtype. Elementwise ops and reductions
  add bytes, not FLOPs. This differs from XLA's ``cost_analysis``, which
  counts an elementwise op's FLOPs too (ROADMAP queue 3).
* **The hand-written kernels** run through ``ctypes``, where neither the
  mode nor ``FlopCounterMode`` sees them. Each wrapper (``csr_spmm``,
  ``embedding_bag``, ``flash_attention``, ``flash_attention_bwd``,
  ``queue_window``, ``cluster_window``) charges the FLOPs and bytes of the
  work it launches, by the formula its source note states for its bound,
  through ``kernels._build`` (``count_launch`` on the card; ``charge`` in
  place of the launch on ``meta``): the two devices are charged alike.
  ``_build`` hands a charge to :meth:`Counter.take_charge` of each counter
  on the launching thread's dispatch-mode stack, so a count takes only
  its own step's launches (autograd's backward threads inherit the
  stack). Each charge is also counted, so a card run's charges can be
  held against ``_build.count_launch``'s launch counts.
* **Live bytes.** Each storage an op makes (not a view of an input) is
  live from then until it is freed (a ``weakref.finalize`` on the
  storage, keyed by ``untyped_storage()._cdata``); :meth:`Counter.track`
  adds storages that exist before the step (parameters, inputs). The
  peak is the port's counterpart of the reference's ``memory_analysis``;
  it does not see the caching allocator's rounding or a library's
  workspace, which ``torch.cuda.max_memory_allocated`` does.
* **A kernel's grid on meta.** Where a launch's shape depends on the
  card (the flash backward's dK/dV split by SM count), a wrapper on
  ``meta`` asks the counter for ``sms``, the SM count of the card it
  prices: ``launch.roofline``'s table for the dry-run, the card's own
  when a card's count is held against meta.

* **One device of a mesh.** A program over a ``DeviceMesh`` runs on
  DTensors (``launch.cell`` with a mesh, under ``launch.mesh.fake_world``).
  The counter declines every op on a DTensor (``NotImplemented``), so
  DTensor runs it as local ops on this rank's shards, and those are what
  it counts: one device's FLOPs, bytes, live storages and kernel
  charges. It runs, but does not count, the ops on the fake tensors of
  DTensor's sharding propagation (an op run once at its global shape to
  learn the output's, then cached): a first step would count them, a
  second not. The collectives DTensor and the model call
  (``_c10d_functional``: all-gather, reduce-scatter, all-reduce,
  all-to-all) are priced as collective bytes by kind, not as HBM bytes,
  by the reference's convention: per device, sized by the output shape
  (``repro/launch/roofline.py::collective_bytes``).

Every loop iteration runs, so every iteration is counted: the reference's
``loop_factor`` (XLA counts a while body once) is 1 here. One card moves
no collective bytes.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ops that overwrite their first (mutated) argument without reading it
_OVERWRITE = frozenset(("copy_", "fill_", "zero_", "normal_", "uniform_",
                        "random_", "bernoulli_", "exponential_"))
# ops that read only their inputs' shapes (those of _WRITE_NOTHING write
# nothing either)
_SHAPE_ONLY = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "zeros_like", "ones_like",
                         "full_like", "new_zeros", "new_ones", "new_full",
                         "randn_like", "rand_like"))
_WRITE_NOTHING = frozenset(("empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided"))
# gathers read only the source elements they gather (the output's size)
_GATHER = frozenset(("index", "index_select", "embedding", "gather", "take",
                     "take_along_dim"))
# in-place scatters read and write only the elements their source touches
_SCATTER_INTO = frozenset(("index_add_", "index_put_", "_index_put_impl_",
                           "scatter_add_", "scatter_", "scatter_reduce_",
                           "index_copy_"))
# the functional collectives (and DTensor's all-to-all between two split
# dims), by the reference's (HLO) kind names
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
_lock = threading.RLock()


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def footprint(t: torch.Tensor) -> int:
    """Bytes ``t`` spans as an operand: its elements, a broadcast
    (stride-0) dim counted once."""
    if t.is_contiguous():
        return t.numel() * t.element_size()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in ``tree``: dicts, lists, tuples and dataclass
    instances (an optimizer's state) walked to their leaves."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(_local(x))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this device holds); ``t`` itself
    for any other tensor."""
    local = getattr(t, "_local_tensor", None)
    return t if local is None else local


def _declined(types) -> bool:
    """Whether an op on ``types`` is left to a tensor subclass that runs
    it as local ops: a DTensor, or a collective's pending result."""
    return any(getattr(t, "__name__", "") in ("DTensor",
                                              "AsyncCollectiveTensor")
               for t in types)


def _fake(types) -> bool:
    """Whether an op runs on fake tensors: DTensor works out an op's
    global output shape so once (its sharding propagation, cached), and
    nothing is computed or stored."""
    return any(getattr(t, "__name__", "") == "FakeTensor" for t in types)


def _flat(values) -> list[torch.Tensor]:
    """The tensors among ``values`` and in their lists and tuples (an ATen
    op's arguments nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _on_device(t: torch.Tensor) -> bool:
    """The tensors that count: those not on the host."""
    return t.device.type != "cpu"


class _OpMeta:
    """What the counter needs of an ATen op, read once per op."""

    def __init__(self, func):
        self.key = str(func)
        self.name = func.overloadpacket.__name__
        self.collective = (_COLLECTIVES.get(self.name)
                           if func.namespace in _COLLECTIVE_NAMESPACES
                           else None)
        self.view = bool(func.is_view) or self.name in _WRITE_NOTHING
        self.flops = flop_registry.get(func.overloadpacket)
        args = func._schema.arguments
        self.write_pos = tuple(i for i, a in enumerate(args)
                               if a.alias_info is not None
                               and a.alias_info.is_write)
        self.write_names = tuple(args[i].name for i in self.write_pos)


_metas: dict = {}


def _op_meta(func) -> _OpMeta:
    meta = _metas.get(func)
    if meta is None:
        meta = _metas[func] = _OpMeta(func)
    return meta


def _op_bytes(meta: _OpMeta, args, kwargs, ins, outs, in_keys) -> int:
    """One op's bytes by the module's rules (see the module's doc)."""
    if meta.view:
        return 0
    name = meta.name
    written: dict[int, torch.Tensor] = {}
    for i, key in zip(meta.write_pos, meta.write_names):
        x = args[i] if i < len(args) else kwargs.get(key)
        for t in _flat((x,)):
            written[id(t)] = t
    if outs and not written and all(
            t.untyped_storage()._cdata in in_keys for t in outs):
        return 0       # every output aliases an input: a view
    first = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if name in _GATHER and first is not None:
        # the indices read, the gathered elements read and written
        rest = [t for t in ins if t is not first]
        return (sum(footprint(t) for t in rest)
                + 2 * sum(footprint(t) for t in outs))
    if name in _SCATTER_INTO and first is not None:
        same = [t for t in ins if t is not first and t.dtype == first.dtype]
        if same:
            # the indices and the source read; the touched elements of
            # self read and written
            rest = [t for t in ins if t is not first]
            return (sum(footprint(t) for t in rest)
                    + 2 * footprint(same[-1]))
    n, seen = 0, set()
    if name not in _SHAPE_ONLY:
        for t in ins:
            if id(t) in seen or (name in _OVERWRITE and id(t) in written):
                continue
            seen.add(id(t))
            n += footprint(t)
    done = set()
    for t in outs:
        if id(t) in done:
            continue
        done.add(id(t))
        if id(t) in written or t.untyped_storage()._cdata not in in_keys:
            n += footprint(t)
    for key, t in written.items():     # mutated, not returned
        if key not in done:
            n += footprint(t)
    return n


class Counter(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes, kernel charges and the live-bytes
    peak of everything run inside ``with Counter() as c:``, on any thread
    the step's ops run on (autograd's backward included). ``sms`` is the
    SM count of the card whose launches a count on ``meta`` stands for
    (see the module's doc)."""

    def __init__(self, sms: int | None = None):
        super().__init__()
        self.sms = sms
        self.flops: dict[str, float] = {}
        self.bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.collectives: dict[str, float] = {}  # kind -> bytes
        self.n_ops = 0
        self.by_op: dict[str, list] = {}   # op -> [calls, flops, bytes]
        self.live = 0
        self.peak = 0
        self.tracked = 0      # live bytes of what track() was given
        self._storages: dict[int, int] = {}

    # ------------------------------------------------------------ state
    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (those on a
        device) as live: what exists before the step and stays."""
        for t in _tensors(trees):
            if _on_device(t):
                self._add_storage(t)
        self.tracked = self.live

    def _add_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with _lock:
            n = self._storages.pop(key, None)
            if n is not None:
                self.live -= n

    def take_charge(self, name: str, flops: float, n_bytes: float,
                    dtype: str) -> None:
        """One launch of kernel ``name`` (``kernels._build.charge``):
        ``flops`` matrix-class operations on ``dtype`` operands and
        ``n_bytes`` moved."""
        with _lock:
            k = self.kernels.setdefault(
                name, {"calls": 0, "flops": 0.0, "bytes": 0.0,
                       "dtype": dtype})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += n_bytes
            if flops:
                self.flops[dtype] = self.flops.get(dtype, 0.0) + flops
            self.bytes += n_bytes

    # ------------------------------------------------------------- mode
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _declined(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _fake(types):
            return out
        ins = _flat(args) + (_flat(kwargs.values()) if kwargs else [])
        outs = _flat((out,))
        if not any(_on_device(t) for t in ins + outs):
            return out
        meta = _op_meta(func)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        with _lock:
            self.n_ops += 1
            if meta.collective is not None:
                n_bytes = float(sum(footprint(t) for t in outs))
                self.collectives[meta.collective] = (
                    self.collectives.get(meta.collective, 0.0) + n_bytes)
            else:
                n_bytes = _op_bytes(meta, args, kwargs, ins, outs, in_keys)
                self.bytes += n_bytes
            n = 0
            if meta.flops is not None:
                n = meta.flops(*args, **kwargs, out_val=out)
                if n:
                    key = dtype_name(ins[0].dtype)
                    self.flops[key] = self.flops.get(key, 0.0) + n
            tally = self.by_op.get(meta.key)
            if tally is None:
                tally = self.by_op[meta.key] = [0, 0.0, 0.0]
            tally[0] += 1
            tally[1] += n
            tally[2] += n_bytes
            for t in outs:
                if _on_device(t) and \
                        t.untyped_storage()._cdata not in in_keys:
                    self._add_storage(t)
        return out

    # ---------------------------------------------------------- results
    def differences(self, other: "Counter") -> dict:
        """op -> ([calls, FLOPs, bytes] here, there) for every op whose
        tally differs between this count and ``other``'s."""
        keys = set(self.by_op) | set(other.by_op)
        zero = [0, 0.0, 0.0]
        return {k: (self.by_op.get(k, zero), other.by_op.get(k, zero))
                for k in sorted(keys)
                if self.by_op.get(k, zero) != other.by_op.get(k, zero)}

    def summary(self) -> dict:
        """FLOPs by dtype and in all, bytes, collective bytes by kind, ops
        counted, the live-bytes peak and each kernel's charges."""
        return {
            "flops_by_dtype": dict(sorted(self.flops.items())),
            "flops": float(sum(self.flops.values())),
            "bytes": float(self.bytes),
            "collective_bytes": dict(sorted(self.collectives.items())),
            "n_ops": self.n_ops,
            "peak_live_bytes": int(self.peak),
            "tracked_bytes": int(self.tracked),
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }


def to_meta(tree):
    """``tree`` (dicts, lists, tuples and dataclass instances of tensors
    and other values) with every tensor replaced by a ``meta`` tensor of
    its shape, dtype, strides and storage offset, over a meta storage of
    its storage's size; tensors that share a storage share one here too,
    and a tensor that requires grad still does."""
    bases: dict[int, torch.Tensor] = {}

    def conv(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            base = bases.get(st._cdata)
            if base is None:
                base = bases[st._cdata] = torch.empty(
                    st.nbytes(), dtype=torch.uint8, device="meta")
            m = base.view(x.dtype) if x.element_size() == 1 else \
                base[:base.numel() // x.element_size() * x.element_size()
                     ].view(x.dtype)
            m = m.as_strided(x.shape, x.stride(), x.storage_offset())
            return m.requires_grad_(x.requires_grad)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: conv(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    return conv(tree)


def count_call(fn, *args, counter: Counter | None = None,
               **kwargs) -> tuple[dict, object]:
    """Run ``fn(*args, **kwargs)`` under a :class:`Counter` (a fresh one
    unless ``counter`` is given) that tracks the arguments as live;
    returns (its summary, fn's result)."""
    c = Counter() if counter is None else counter
    c.track(args, kwargs)
    with c:
        out = fn(*args, **kwargs)
    return c.summary(), out
