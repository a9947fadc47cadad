"""Build and load the hand-written CUDA kernels (nvcc by hand, ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch_kernels/lib<name>-<digest>.so`` at the repository root,
for ``sm_90a`` (Hopper).  The digest covers the source and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.  Nothing
builds at import: the first call that needs a kernel builds it, and
:func:`build_all` starts every build at once (one ``nvcc`` per source, in
parallel) for callers that want the build time up front.

The libraries are loaded with :mod:`ctypes`; every pointer and the stream go
through ``c_void_p`` (an ``int`` argument would cut a 64-bit pointer).
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
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<repo>/build/repro_torch_kernels`` (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: The C signature of every exported function, per source.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "conv_mapmajor": {
        "conv_mapmajor_launch": (_I, [_P, _P, _P, _P] + [_I] * 14 + [_P]),
        "conv_mapmajor_smem_bytes": (ctypes.c_longlong, [_I] * 6),
        "conv_mapmajor_max_u": (_I, []),
        "conv_mapmajor_grid_blocks": (ctypes.c_longlong, [_I] * 10),
    },
    "matmul_mapmajor": {
        "matmul_mapmajor_launch": (_I, [_P] * 5 + [_I] * 6 + [_P]),
        "matmul_mapmajor_block_k": (_I, []),
        "matmul_mapmajor_grid_blocks": (ctypes.c_longlong, [_I] * 4),
    },
    "conv_mapmajor_int8": {
        "conv_mapmajor_int8_launch": (_I, [_P] * 5 + [_I] * 14 + [_P]),
        "conv_mapmajor_int8_smem_bytes": (ctypes.c_longlong, [_I] * 5),
        "conv_mapmajor_int8_max_u": (_I, []),
        "conv_mapmajor_int8_grid_blocks": (ctypes.c_longlong, [_I] * 10),
    },
    "matmul_mapmajor_int8": {
        "matmul_mapmajor_int8_launch": (_I, [_P] * 6 + [_I] * 6 + [_P]),
        "matmul_mapmajor_int8_grid_blocks": (ctypes.c_longlong, [_I] * 3),
        "matmul_mapmajor_int8_block_k": (_I, []),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: What the last builds reported: name -> (seconds, nvcc/ptxas output).
build_log: Dict[str, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start ``nvcc`` for one source into a temporary file, or return None
    when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build_all(names: Optional[List[str]] = None) -> Dict[str, tuple]:
    """Build every kernel library that is not built yet, all ``nvcc`` runs
    started together.  Returns :data:`build_log` for the names asked:
    (seconds since the builds started, compiler output)."""
    names = list(names or SIGNATURES)
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        failed = []
        for n, job in started.items():
            if job is None:
                build_log.setdefault(n, (0.0, "already built"))
                continue
            proc, tmp = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, library_path(n))
            build_log[n] = (time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: build_log[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _loaded[name] = lib
    return lib


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(kernel: str, err: int) -> None:
    """Raise if a launch function returned an error (0 is success)."""
    if err == 1000:
        raise ValueError(f"{kernel}: arguments the kernel does not take")
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
