"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``*.cu`` source compiles on its own with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers), all
sources in parallel, into ``build/repro_torch/`` at the repository root.
Library names carry a hash of every source, header and flag, so an edited
source rebuilds and an unchanged one loads the library already built. The
libraries load with ``ctypes``; each C entry point takes every pointer and
the stream as ``c_void_p`` and returns a ``cudaError_t``.

Nothing here runs at import time: the first kernel launch builds. A build
failure raises with the compiler's output; nothing falls back. Processes
that build at once (the ranks of a tensor-parallel serve) take turns on a
file lock in the build directory, so each source compiles once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each entry point: (source stem, symbol) -> argtypes
SIGNATURES = {
    ("lut_gemm", "lut_gemm_launch"): [_P] * 5 + [_I] * 10 + [_P],
    ("lut_gemm", "lut_gemm_active_clusters"): [_I] * 10,
    ("dequant_matmul", "dequant_matmul_launch"): [_P] * 5 + [_I] * 10 + [_P],
    ("dequant_matmul", "dequant_matmul_active_clusters"): [_I] * 9,
    ("lut_gemm_bs_fused", "lut_gemm_bs_fused_launch"): [_P] * 5 + [_I] * 12 + [_P],
    ("lut_gemm_bs_fused", "lut_gemm_bs_fused_active_clusters"): [_I] * 12,
    ("paged_attention", "paged_attention_launch"): [_P] * 8 + [_I] * 11 + [_P],
    ("paged_attention", "paged_attention_active_clusters"): [_I] * 11,
    ("paged_attention", "paged_attention_splitkv_launch"): [_P] * 11 + [_I] * 13
                                                           + [_P],
    ("paged_attention", "paged_attention_splitkv_active_clusters"): [_I] * 13,
    ("expert_gemm", "expert_dequant_matmul_launch"): [_P] * 6 + [_I] * 11 + [_P],
    ("expert_gemm", "expert_dequant_matmul_active_clusters"): [_I] * 10,
    ("expert_gemm", "expert_lut_gemm_launch"): [_P] * 6 + [_I] * 10 + [_P],
    ("expert_gemm", "expert_lut_gemm_active_clusters"): [_I] * 10,
    ("kv_cache_attention", "kv_cache_attention_launch"): [_P] * 7 + [_I] * 9 + [_P],
    ("kv_cache_attention", "kv_cache_attention_active_clusters"): [_I] * 9,
    ("lut_gemm_bitsliced", "lut_gemm_bitsliced_launch"): [_P] * 4 + [_I] * 9 + [_P],
    ("lut_gemm_bitsliced", "lut_gemm_bitsliced_active_clusters"): [_I] * 9,
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(stem: str, digest: str) -> Path:
    return BUILD_DIR / f"{stem}-{digest}.so"


@contextlib.contextmanager
def _build_lock():
    """Hold an exclusive lock on the build directory (across processes)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build() -> dict[str, dict]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together, with ``-Xptxas -v`` (registers, shared
    memory and spills per kernel). The compiler's log is kept beside each
    library. Returns ``{stem: {"seconds", "log", "path", "built"}}`` for
    every source: ``built`` is false, and ``seconds`` 0, where the library
    was already there."""
    with _build_lock():
        return _build(_digest())


def _build(digest: str) -> dict[str, dict]:
    nvcc = nvcc_path()
    done = {}
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem, digest)
        if out.exists():
            log_path = out.with_suffix(".log")
            done[src.stem] = {"seconds": 0.0, "path": str(out), "built": False,
                              "log": log_path.read_text() if log_path.exists()
                              else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o",
               str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out,
                           time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc={proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[stem] = {"seconds": secs, "log": log, "path": str(out),
                      "built": True}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed,
    with every entry point's argtypes and restype declared."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is not None:
            return lib
        path = _lib_path(stem, _digest())
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for (s, sym), argtypes in SIGNATURES.items():
            if s == stem:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[stem] = lib
        return lib


def loaded() -> int:
    """How many kernel libraries this process has loaded (each is built, or
    found built, at its first use): the engine reads it around a forward
    to see whether that forward paid for a build."""
    return len(_LIBS)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
