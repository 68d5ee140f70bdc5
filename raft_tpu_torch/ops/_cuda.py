"""Builder and loader of the hand-written kernels in ``raft_tpu_torch/csrc``.

At first use :func:`library` compiles every ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` — one ``nvcc -c`` per source, all started together — links the
objects into ONE shared library under ``build/raft_tpu_torch/`` (listed in
``.gitignore``) and loads it with :mod:`ctypes`.  The library's file name
carries a hash of the sources and flags, so a changed source builds anew
and an unchanged one loads the library already built.

The sources expose a plain C interface (no PyTorch headers, which would
take minutes to compile): pointers, ints and the CUDA stream go in as
``ctypes`` arguments, and every entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "raft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, so ctypes never truncates an address to a 32-bit int)
SIGNATURES = {
    "raft_kmeans_assign_update": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                  _P, _P),
    "raft_ivf_pq_scan_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P, _P, _P),
    "raft_ivf_pq_scan_codes_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                     _P, _P),
    "raft_ivf_pq_scan_codes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "raft_ivf_pq_scan_recon8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P, _P, _P),
    "raft_ivf_flat_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P),
    "raft_ivf_pq_scan_recon": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P, _P, _P),
    "raft_fused_l2_nn": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "raft_cagra_hop": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "raft_tpu_torch's kernels")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _build(out: pathlib.Path, sources) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               tmp_so], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = _sources()
    out = BUILD_DIR / f"libraft_tpu_torch_{_digest(sources)}.so"
    t0 = time.perf_counter()
    if not out.exists():
        _build(out, sources)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.raft_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.raft_cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().raft_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
