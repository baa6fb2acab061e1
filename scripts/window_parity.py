#!/usr/bin/env python3
"""Hold the env window kernels against another build of them, bit for bit,
and time both, on one CUDA card.

Usage (from the repository root, on a machine with an H100):

    python3 scripts/window_parity.py --baseline OTHER/csrc [--phases] [--train]

``OTHER/csrc`` holds another ``queue_window.cu``, ``cluster_window.cu``
and the ``fluid_window.cuh`` they include, with the same C entries
(``queue_window_f32``, ``cluster_window_f32``), for example an earlier
commit's sources unpacked by ``git archive`` into the gitignored
``build/``. They are compiled by ``nvcc`` with the committed flags
(``-fmad=false``) into ``build/window_parity/`` and loaded with
``ctypes``; the committed kernels are built and launched through their
wrappers.

On every case of ``chip_smoke.py``'s kernel-vs-plain phases (the queue
window: every scenario code at every W at P = 3, 1, 2, 4, 8 and 16 and
P = 3 under the memory spill; the cluster window: every archetype, live-peer
count, W and queue code in three sync modes and peer policies at the same
P, and the zero-peer clean batches of its reduction check), and on P = 3
batches whose carried backlogs are scaled by 1e25 (past the range of the
scan's fast division, so its second pass runs), both builds run on the
same packed operands, and every output must be equal bit for bit (NaN
patterns included). The scan's fast division is also held bit-equal to
``/`` wherever it reports its range holds, on 2 x 2^24 drawn pairs. Then each kernel is timed at the timing
rows' shapes, 32 envs, P = 3, W = 128, every step live, and at 64 envs
(the reference's batch), by ``chip_smoke.Timer`` (CUDA events, L2 zeroed,
a spin queued before each call; median of 25), in the order committed,
baseline, baseline, committed. ``--phases`` adds each block's phases at
32 envs, by ``clock64()`` read by thread 0 after every block barrier in a
build of the committed sources (the stage, the live-step count, the
chains, the prologue, the peers' walk and terms, the scan, the epilogue
and the sums), and the same in a probe build whose scan divides by
``__fdividef`` (no slow-path branch; its outputs are not compared): what
the two IEEE divisions on the scan's chain cost. ``--train`` profiles
policy training in the queue and cluster envs (``chip_smoke``'s
``policy_profile``: host wall, device busy and idle share an iteration)
with the committed window kernels and the baseline's, in the order
committed, baseline, baseline, committed. It prints the card's
name and power limit first and a JSON summary last, and exits non-zero
without a card or if a bit differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "window_parity"
STEMS = ("queue_window", "cluster_window")


def build_baseline(src: pathlib.Path) -> dict:
    """{stem: ctypes entry} of the baseline sources, compiled at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    for name in (*(f"{s}.cu" for s in STEMS), "fluid_window.cuh"):
        shutil.copy(src / name, OUT / name)
    nvcc = _build._nvcc()
    procs = {stem: subprocess.Popen(
        [nvcc, *_build._flags(stem), "-o", str(OUT / f"lib{stem}.so"),
         str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for stem in STEMS}
    fns = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"window_parity: baseline {stem} failed\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{stem}.so")), f"{stem}_f32")
        fn.argtypes = _build.ENTRIES[f"{stem}_f32"][1]
        fn.restype = ctypes.c_int
        fns[stem] = fn
    return fns


CLOCKED = r"""
#define FLUID_CLOCK() do { if (threadIdx.x == 0) fluid_phase_clock[ \
    blockIdx.x * MAX_MARKS + fluid_mark++] = clock64(); } while (0)
"""


# the scan's two IEEE divisions a step, and the approximate division that
# replaces them in the probe build (its outputs are not compared)
APPROX = (("v[r] = cur.free[r] + div(x + y, cur.den[r], cur.rcp[r]);",
           "v[r] = cur.free[r] + __fdividef(x + y, cur.den[r]);"),
          ("div(alpha_crit * rb_wall, window, rcp_window) * rb_gate;",
           "__fdividef(alpha_crit * rb_wall, window) * rb_gate;"))

# div_fast against `/` on pairs the host draws: [mismatches where the
# divisor is in fast_range and div_fast reports the numerator in range,
# pairs in that range]
DIVCHECK = r"""
#include "fluid_window.cuh"

__global__ void div_check_kernel(const float* a, const float* b,
                                 unsigned* counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i];
  unsigned bad = 0u;
  const float q = fluid::div_fast(x, y, fluid::div_rcp(y), bad);
  const float want = x / y;
  if (bad || !fluid::fast_range(y)) return;
  atomicAdd(&counts[1], 1u);
  if (__float_as_uint(q) != __float_as_uint(want) && !(q != q && want != want))
    atomicAdd(&counts[0], 1u);
}

extern "C" int div_check(const void* a, const void* b, void* counts, int n) {
  div_check_kernel<<<(n + 255) / 256, 256>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<unsigned*>(counts), n);
  return static_cast<int>(cudaGetLastError());
}
"""


def division_check(torch, dev) -> dict:
    """div_fast bit-equal to `/` wherever it reports its range holds, on
    2^24 pairs of random bit patterns (every exponent, zeros, subnormals,
    infinities, NaNs) and 2^24 pairs of signed log-uniform magnitudes in
    [1e-12, 1e12] with a zero numerator in 1 of 16: {kind: (mismatches,
    pairs in range)}."""
    from repro_torch.kernels import _build

    out = OUT / "divcheck"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "fluid_window.cuh", out / "fluid_window.cuh")
    (out / "div_check.cu").write_text(DIVCHECK)
    proc = subprocess.run(
        [_build._nvcc(), *_build._flags("queue_window"), "-o",
         str(out / "libdiv_check.so"), str(out / "div_check.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"window_parity: div_check failed\n{proc.stdout}"
                         f"{proc.stderr}")
    fn = ctypes.CDLL(str(out / "libdiv_check.so")).div_check
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,)
    fn.restype = ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(7)
    n = 1 << 24
    cases = {}
    bits = torch.randint(-2**31, 2**31 - 1, (2, n), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)
    cases["random bits"] = (bits[0], bits[1])
    mag = 10.0 ** (24 * torch.rand((2, n), generator=g, device=dev) - 12)
    sign = torch.where(torch.rand((2, n), generator=g, device=dev) < 0.5,
                       -1.0, 1.0)
    vals = (mag * sign).float()
    vals[0][torch.rand(n, generator=g, device=dev) < 1 / 16] = 0.0
    cases["log-uniform"] = (vals[0], vals[1])
    found = {}
    for kind, (x, y) in cases.items():
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        _build.check("div_check", fn(x.contiguous().data_ptr(),
                                     y.contiguous().data_ptr(),
                                     counts.data_ptr(), n))
        torch.cuda.synchronize()
        found[kind] = tuple(counts.tolist())
    return found


def build_clocked(name: str = "clocked", edits=()) -> dict:
    """{stem: (entry, reader)} of the committed sources with a clock64()
    read by thread 0 after every block barrier (and at the start and the
    end), kept per block: the phases' cycles. ``edits`` are (old, new)
    replacements in the header (each must be found)."""
    from repro_torch.kernels import _build

    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    head = (_build.CSRC / "fluid_window.cuh").read_text()
    for old, new in edits:
        if old not in head:
            raise SystemExit(f"window_parity: {name}: no '{old}' in the "
                             "header")
        head = head.replace(old, new)
    head = head.replace("namespace fluid {", "namespace fluid {\n"
                        "constexpr int MAX_MARKS = 16;\n"
                        "__device__ long long fluid_phase_clock[4096 * 16];"
                        + CLOCKED, 1)
    head = head.replace("extern __shared__ float smem[];",
                        "extern __shared__ float smem[];\n  int fluid_mark = 0;"
                        "\n  FLUID_CLOCK();", 1)
    head = head.replace("__syncthreads();", "__syncthreads(); FLUID_CLOCK();")
    for mark in ("(static_cast<float>(tid) < eff_window);",
                 "&& fast_range(window) && fast_range(sh_rate);"):
        if mark not in head:
            raise SystemExit(f"window_parity: no '{mark}' in the header")
        head = head.replace(mark, mark + "\n  FLUID_CLOCK();", 1)
    head = head.replace("#undef SO", "__syncthreads(); FLUID_CLOCK();\n"
                        "#undef SO", 1)
    (out / "fluid_window.cuh").write_text(head)
    reader = ("\nextern \"C\" int fluid_clocks(void* out, int n) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, "
              "fluid::fluid_phase_clock, sizeof(long long) * 16 * n));\n}\n")
    for stem in STEMS:
        (out / f"{stem}.cu").write_text(
            (_build.CSRC / f"{stem}.cu").read_text() + reader)
    nvcc = _build._nvcc()
    procs = {stem: subprocess.Popen(
        [nvcc, *_build._flags(stem), "-o", str(out / f"lib{stem}.so"),
         str(out / f"{stem}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for stem in STEMS}
    fns = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"window_parity: clocked {stem} failed\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        fn = getattr(lib, f"{stem}_f32")
        fn.argtypes = _build.ENTRIES[f"{stem}_f32"][1]
        fn.restype = ctypes.c_int
        rd = lib.fluid_clocks
        rd.argtypes = (ctypes.c_void_p, ctypes.c_int)
        rd.restype = ctypes.c_int
        fns[stem] = (fn, rd)
    return fns


def bits(torch, t):
    return t.contiguous().view(torch.int32)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, type=pathlib.Path,
                        help="a directory with queue_window.cu, "
                        "cluster_window.cu and fluid_window.cuh")
    parser.add_argument("--train", action="store_true",
                        help="also profile policy training in the queue "
                        "and cluster envs with each build's kernels, in "
                        "turns (chip_smoke.policy_profile)")
    parser.add_argument("--phases", action="store_true",
                        help="also time each block's phases by clock64() "
                        "in a build of the committed sources with a clock "
                        "read after every block barrier, and in a probe "
                        "build whose scan divides approximately")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("window_parity: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.core import cost_model as cm, queue_sim as qs
    from repro_torch.kernels import _build
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.kernels.queue_window import ops as qw

    smi = cs.smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    _build.build_all()
    base = build_baseline(args.baseline)
    stream = torch.cuda.current_stream(dev).cuda_stream
    theta = cm.CostModelParams()

    def queue_ops(q):
        cfg, params, sc, vol, fabric, uniforms, window, eff, pos = q
        packed = qw.pack(cfg, params, sc, vol, fabric, window, eff, pos)
        n, p = fabric.backlog.shape
        outs = [(torch.empty((n, len(qw.ACC)), device=dev),
                 torch.empty((n, len(qw.ACC_OWNERS), p), device=dev),
                 torch.empty_like(packed[3])) for _ in range(2)]

        def mine():
            qw.launch(*packed, uniforms, *outs[0], cfg.n_epochs,
                      cfg.steps_per_epoch)

        def theirs():
            err = base["queue_window"](
                *(t.data_ptr() for t in (*packed, uniforms, *outs[1])), n, p,
                cfg.n_epochs, cfg.steps_per_epoch, stream)
            _build.check("baseline queue_window_f32", err)
        return mine, theirs, outs

    def cluster_ops(c):
        cfg, ego, sc, vol, fabric, peers, peer_state, uniforms, window, eff, \
            pos = c
        packed = qw.pack(cfg, ego, sc, vol, fabric, window, eff, pos)
        pk = cw.pack_peers(ego, peers, peer_state)
        n, p = fabric.backlog.shape
        outs = [cw.outputs(packed[3]) for _ in range(2)]

        def mine():
            cw.launch(*packed, uniforms, *pk, *outs[0], cfg.n_epochs,
                      cfg.steps_per_epoch)

        def theirs():
            err = base["cluster_window"](
                *(t.data_ptr() for t in (*packed, uniforms, *pk, *outs[1])),
                n, p, cfg.n_epochs, cfg.steps_per_epoch, stream)
            _build.check("baseline cluster_window_f32", err)
        return mine, theirs, outs

    def compare(label, mine, theirs, outs) -> int:
        for o in outs:
            for t in o:
                t.fill_(float("nan"))
        mine()
        theirs()
        torch.cuda.synchronize()
        n_out = 0
        for a, b in zip(*outs):
            n_out += a.numel()
            if not torch.equal(bits(torch, a), bits(torch, b)):
                diff = int((bits(torch, a) != bits(torch, b)).sum())
                print(f"window_parity: {label}: {diff} of {a.numel()} "
                      f"values of an output {tuple(a.shape)} differ",
                      file=sys.stderr)
                return -1
        return n_out

    cases = ((3, 0.0), (3, 0.3), (1, 0.0), (2, 0.0), (4, 0.0), (8, 0.0),
             (16, 0.0))
    codes = sorted(qs.SCENARIO_CODES.values())
    checked = {"queue_window": 0, "cluster_window": 0}
    for p, mem in cases:
        q = cs.queue_window_operands(torch, dev, theta, p, codes,
                                     cm.WINDOW_CHOICES, mem=mem)
        n_out = compare(f"queue_window P={p} mem {mem}", *queue_ops(q))
        if n_out < 0:
            return 1
        checked["queue_window"] += n_out
        print(f"queue_window P={p} mem {mem}: {q[6].shape[0]} envs, "
              f"{n_out} outputs bit-equal", flush=True)
    batches = [(s, pol, cs.SEED + b, False) for b, (s, pol) in enumerate((
        ("allreduce", "static"), ("reduce_scatter", "greendygnn"),
        ("none", "mixed")))] + [("allreduce", "mixed", cs.SEED, True)]
    for p, mem in cases:
        for sync, policy, seed, clean in batches:
            c = cs.cluster_window_operands(
                torch, dev, theta, p, cm.WINDOW_CHOICES, mem=mem, sync=sync,
                policy=policy, seed=seed, clean=clean)
            label = (f"cluster_window P={p} mem {mem} {sync}/{policy}"
                     f"{' clean' if clean else ''}")
            n_out = compare(label, *cluster_ops(c))
            if n_out < 0:
                return 1
            checked["cluster_window"] += n_out
            print(f"{label}: {c[8].shape[0]} envs, {n_out} outputs "
                  "bit-equal", flush=True)

    # backlogs of 1e25 and more (past div_fast's range): the scan's second
    # pass, dividing by `/`
    import dataclasses

    q = cs.queue_window_operands(torch, dev, theta, 3, codes,
                                 cm.WINDOW_CHOICES)
    q = q[:4] + (dataclasses.replace(q[4], backlog=q[4].backlog * 1e25),) \
        + q[5:]
    c = cs.cluster_window_operands(torch, dev, theta, 3, cm.WINDOW_CHOICES)
    c = c[:4] + (dataclasses.replace(c[4], backlog=c[4].backlog * 1e25),) \
        + c[5:]
    for label, ops in (("queue_window past the fast range", queue_ops(q)),
                       ("cluster_window past the fast range",
                        cluster_ops(c))):
        n_out = compare(label, *ops)
        if n_out < 0:
            return 1
        checked[label.split()[0]] += n_out
        print(f"{label}: {n_out} outputs bit-equal", flush=True)

    div_bad = division_check(torch, dev)
    print(f"div_fast against '/': (mismatches, pairs in its range) "
          f"{div_bad} of 2^24 pairs each", flush=True)
    if any(bad for bad, _ in div_bad.values()):
        print("window_parity: div_fast differs from '/'", file=sys.stderr)
        return 1

    timer = cs.Timer(torch, dev)
    times = {}
    pool = sorted(qs.default_training_pool())
    for n in (32, 64):
        q = cs.queue_window_operands(torch, dev, theta, 3,
                                     (pool * 12)[:n], (128,),
                                     seed=cs.SEED + 1)
        q = q[:7] + (q[6].clone(), q[8])          # every step live
        c = cs.cluster_window_operands(torch, dev, theta, 3,
                                       (128,) * (n // 16), seed=cs.SEED + 1)
        c = c[:9] + (c[8].clone(), c[10])
        for stem, (mine, theirs, _) in (("queue_window", queue_ops(q)),
                                        ("cluster_window", cluster_ops(c))):
            got = {"committed": [], "baseline": []}
            for name in ("committed", "baseline", "baseline", "committed"):
                got[name].append(timer.ms(mine if name == "committed"
                                          else theirs))
            times[f"{stem} n={n}"] = got
            print(f"time {stem} n={n} P=3 W=128: committed "
                  f"{got['committed']} ms, baseline {got['baseline']} ms; "
                  f"{smi}", flush=True)
    phases = {}
    if args.phases:
        import statistics

        builds = {"exact": build_clocked(),
                  "approximate scan divisions": build_clocked(
                      "clocked_approx", APPROX)}
        n = 32
        q = cs.queue_window_operands(torch, dev, theta, 3,
                                     (pool * 12)[:n], (128,),
                                     seed=cs.SEED + 1)
        q = q[:7] + (q[6].clone(), q[8])
        c = cs.cluster_window_operands(torch, dev, theta, 3,
                                       (128,) * (n // 16), seed=cs.SEED + 1)
        c = c[:9] + (c[8].clone(), c[10])
        for build, clocked in builds.items():
            for stem, ops in (("queue_window", queue_ops(q)),
                              ("cluster_window", cluster_ops(c))):
                fn, rd = clocked[stem]
                saved = base[stem]
                base[stem] = fn           # theirs() now launches this build
                mine, theirs, outs = ops
                for _ in range(3):
                    theirs()
                torch.cuda.synchronize()
                base[stem] = saved
                marks = (ctypes.c_longlong * (16 * n))()
                _build.check("fluid_clocks", rd(marks, n))
                rows = [[marks[b * 16 + k] for k in range(16)]
                        for b in range(n)]
                k_max = max(k for k in range(1, 16) if rows[0][k] > 0)
                deltas = [statistics.median(r[k] - r[k - 1] for r in rows)
                          for k in range(1, k_max + 1)]
                phases[f"{stem}, {build}"] = deltas
                print(f"phases {stem} ({build}) n={n} P=3 W=128 (clock64 "
                      "cycles a block, median over blocks, barrier to "
                      f"barrier): {deltas}, total {sum(deltas)}", flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    if args.train:
        from repro_torch.train import policy as pol

        from repro_torch.core import dqn
        from repro_torch.envs import resolve_env

        pool = pol.make_params_pool([theta], device=dev)
        entry = _build.entry
        names = {f"{stem}_f32": stem for stem in STEMS}

        def use(build):
            _build.entry = entry if build == "committed" else (
                lambda name: base[names[name]] if name in names
                else entry(name))

        # a warm-up run of each env with each build: the profiled pairs
        # must not pay a first use
        for env_name in ("queue", "cluster"):
            for build in ("committed", "baseline"):
                use(build)
                try:
                    dqn.train_dqn(dqn.DQNConfig(
                        n_envs=cs.POLICY_ENVS, iterations=60,
                        min_replay=cs.POLICY_ENVS, eps_decay_iters=60,
                        seed=cs.SEED, device=str(dev)),
                        cs.training_cfg(env_name), pool,
                        env=resolve_env(env_name))
                finally:
                    _build.entry = entry
        for env_name in ("queue", "cluster"):
            for build in ("committed", "baseline", "baseline", "committed"):
                use(build)
                try:
                    print(f"train {env_name}, {build} window kernels:",
                          flush=True)
                    cs.policy_profile(torch, dev, env_name, pool)
                finally:
                    _build.entry = entry
    print(json.dumps({"checked_outputs": checked, "div_mismatches": div_bad,
                      "ms": times, "phases_cycles": phases, "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
