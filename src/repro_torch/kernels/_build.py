"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``; the sources
are compiled in parallel, one ``nvcc`` each. Libraries land in
``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source text, of the ``csrc/``
headers it includes and of the flags, so an edited source or header is
rebuilt on first use and an unchanged one is reused.

Nothing is built at import time: the first kernel launch (or an explicit
:func:`build_all`) builds. Without ``nvcc`` the build raises; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: name -> (source stem, ctypes argtypes). Every entry
# returns cudaGetLastError() as an int.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    "block_spmm_f32": ("block_spmm", (_P, _P, _P, _P, _P, _I, _I, _P)),
    # rowptr, col, val, x, y, n_rows, f, ldx, ldy, vec, stream
    "csr_spmm_f32": ("csr_spmm", (_P,) * 5 + (_I,) * 5 + (_P,)),
    # idx, w, offsets, table, out, n_bags, d, n_lookups, max_len, stream
    "embedding_bag_f32": ("embedding_bag", (_P,) * 5 + (_I,) * 4 + (_P,)),
    # q, k, v, o, lse (or null), dtype code, D, B, Sq, Sk, Hq, Hkv, 12
    # strides, causal, stream
    "flash_attention_fwd": ("flash_attention",
                            (_P,) * 5 + (_I,) * 7 + (_L,) * 12 + (_I, _P)),
    # q, k, v, o, do, dq, dk, dv, lse (the forward's), delta and part
    # (scratch), dtype code, D, B, Sq, Sk, Hq, Hkv, split, 24 strides,
    # causal, stream
    "flash_attention_bwd": ("flash_attention_bwd",
                            (_P,) * 11 + (_I,) * 8 + (_L,) * 24 + (_I, _P)),
    # scal, ints, own, state, unif, acc, acc_own, state_out, n, P,
    # n_epochs, steps_per_epoch, stream
    "queue_window_f32": ("queue_window", (_P,) * 8 + (_I,) * 4 + (_P,)),
    # scal, ints, own, state, unif, pscal, pown, acc, acc_own, state_out,
    # pstate_out, pback_out, n, P, n_epochs, steps_per_epoch, stream
    "cluster_window_f32": ("cluster_window", (_P,) * 12 + (_I,) * 4 + (_P,)),
}
# Flags a source takes beyond NVCC_FLAGS: the envs' window scans keep every
# product and sum apart (no FMA contraction), as their plain versions'
# eager operations round them.
EXTRA_FLAGS = {"queue_window": ("-fmad=false",),
               "cluster_window": ("-fmad=false",)}

_lock = threading.Lock()
_launch_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # stem -> nvcc's output (ptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels cannot be built"
    )


def _flags(stem: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(stem, ())


def sources(stem: str) -> list[pathlib.Path]:
    """The source ``stem.cu`` and the ``csrc/`` headers it includes
    (``#include "name"``), the source first."""
    src = CSRC / f"{stem}.cu"
    headers = re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)
    return [src] + [CSRC / h for h in headers]


def _lib_path(stem: str) -> pathlib.Path:
    text = b"".join(p.read_bytes() for p in sources(stem))
    h = hashlib.sha256(text + " ".join(_flags(stem)).encode()).hexdigest()[:16]
    return BUILD_DIR / h / f"lib{stem}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all at once.

    Returns {stem: seconds} for what was compiled. Raises with nvcc's
    output if any compilation fails."""
    stems = sorted({stem for stem, _ in ENTRIES.values()})
    todo = [s for s in stems if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for stem in todo:
        out = _lib_path(stem)
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        procs[stem] = (tmp, subprocess.Popen(
            [nvcc, *_flags(stem), "-o", tmp, str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    secs, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        secs[stem] = time.perf_counter() - t0
        build_logs[stem] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{stem}.cu:\n{log}")
        else:
            _lib_path(stem).with_suffix(".log").write_text(log)
            os.replace(tmp, _lib_path(stem))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def build_log(stem: str) -> str | None:
    """nvcc's output (the ptxas -v report) for the library ``stem`` now
    resolves to, kept beside it; None if it has not been built."""
    if stem in build_logs:
        return build_logs[stem]
    path = _lib_path(stem).with_suffix(".log")
    return path.read_text() if path.exists() else None


def entry(name: str):
    """The ctypes function ``name``, building its library on first use."""
    stem, argtypes = ENTRIES[name]
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = _lib_path(stem)
            if not path.exists():
                build_all()
            lib = _libs[stem] = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, and to the launching thread's entry
    in ``wrapper.launches_by_thread`` (by thread name), under a lock: the
    pipeline's builder thread launches kernels beside the trainer's
    thread, and ``+= 1`` on an attribute is a read, an add and a write
    that a thread switch can split."""
    name = threading.current_thread().name
    with _launch_lock:
        wrapper.launches += 1
        by_thread = wrapper.launches_by_thread
        by_thread[name] = by_thread.get(name, 0) + 1
