"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``_build/`` beside this file (a
directory git ignores) on first use.  The file name carries a digest of
the sources and flags, so an edited kernel is rebuilt and a stale one is
never loaded.  :func:`build_all` starts one nvcc per source, all at once.

Flags: ``-fmad=false`` keeps ``idle - p*req`` from contracting into an FMA
(the plain versions round the product and the difference separately);
there is no ``--use_fast_math``, so divisions are IEEE.

Each wrapper counts its launches through :func:`launched`, which also
holds them to one thread: the plans' outputs are overwritten by their
next launch and K16's count words are shared by every caller of a
device, so a caller that moves a cycle's device work onto a thread of
its own (the pipelined executor's decide worker) pins that thread with
:func:`pin_launch_thread`, and a launch from any other thread raises,
naming both.  Functions in :data:`ON_BUILD` are called with (name,
seconds) after each build (the kernel profiler's build counter).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "admit_chunk", "lex_argmin", "decode_deferred", "segment_sum",
    "seg_scan", "claim_nodes", "canon_pick", "canon_commit",
    "turn_caps", "turn_fill", "pa_fit", "pa_shape",
    "round_products", "union_fit", "window_gate", "stable_compact",
    "queue_order", "row_scatter", "stable_sort", "ordered_scan",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[tuple, object] = {}
# name -> (seconds, ptxas report) of builds this process ran
BUILD_LOG: Dict[str, tuple] = {}
# called with (name, seconds) after each successful build
ON_BUILD: List[Callable[[str, float], None]] = []


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together.  Returns seconds per build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, out + err)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            continue
        os.replace(tmp, target)
        for fn in ON_BUILD:
            fn(name, BUILD_LOG[name][0])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n][0] for n in todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def bind(source: str, fn_name: str, signatures: Dict[str, tuple]):
    """C function ``fn_name`` of kernel ``source`` with its argtypes set
    from the wrapper's declared signature table, bound once a process."""
    fn = _BOUND.get((source, fn_name))
    if fn is None:
        fn = getattr(load(source), fn_name)
        fn.argtypes = list(signatures[fn_name])
        fn.restype = ctypes.c_int
        _BOUND[(source, fn_name)] = fn
    return fn


# ---- launch helpers shared by the wrappers ----

# the thread every launch must come from (None: any thread)
_LAUNCH_THREAD: List[Optional[threading.Thread]] = [None]


def pin_launch_thread(thread: Optional[threading.Thread]) -> None:
    """Hold every later launch to ``thread`` (None lifts the pin)."""
    _LAUNCH_THREAD[0] = thread


def launch_thread() -> Optional[threading.Thread]:
    """The pinned launching thread (None: any thread may launch)."""
    return _LAUNCH_THREAD[0]


def check_launch_thread(what: str) -> None:
    """Raise unless the calling thread may launch device work."""
    owner = _LAUNCH_THREAD[0]
    here = threading.current_thread()
    if owner is not None and owner is not here:
        raise RuntimeError(f"{what} launched from thread {here.name!r}; the device work of "
                           f"this process is pinned to thread {owner.name!r}")


def launched(fn, n: int = 1) -> None:
    """Count ``n`` launches of wrapper (or plan class) ``fn``, from the
    pinned thread only."""
    check_launch_thread(fn.__name__)
    fn.launches += n


P = ctypes.c_void_p
I = ctypes.c_int


def ptr(t) -> int:
    """Device pointer of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()


def stream() -> int:
    """The current device's current stream as a raw pointer, without
    building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def require(t: torch.Tensor, dtype: torch.dtype, name: str, device=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` (when given)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
