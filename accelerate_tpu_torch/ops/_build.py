"""Build and load the port's CUDA kernels (plain C ABI, bound with ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library at first use — one ``nvcc`` per source, all started together —
and loaded with :mod:`ctypes`.  No PyTorch headers and no ``ninja`` are
involved, so a build takes seconds.  Libraries land in ``ops/build/``
(ignored by git) under a name carrying a hash of the sources, so an edited
kernel is rebuilt and an unchanged one is reused; each library's
``nvcc -Xptxas -v`` report (registers, shared memory, spills) lands beside it
as ``.log``.  A failed build raises: there is no fallback to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: paged kernels: q, pages_k, pages_v, k_scales, v_scales, tables, lengths,
#: out; n, s, hq, hkv, d, page, num_p, q_bf16, kv_bf16; scale; stream
_PAGED_ARGS = [_P] * 8 + [_I] * 9 + [_F, _P]
#: flash forward: q, k, v, seg, out, lse; b, sq, sk, hq, hkv, d, seg_stride,
#: causal, bf16; scale; stream
_FWD_ARGS = [_P] * 6 + [_I] * 9 + [_F, _P]
#: flash dq: q, k, v, dout, lse, delta, seg, dq; then as the forward
_DQ_ARGS = [_P] * 8 + [_I] * 9 + [_F, _P]
#: flash dk/dv: q, k, v, dout, lse, delta, seg, dk, dv; then as the forward
_DKV_ARGS = [_P] * 9 + [_I] * 9 + [_F, _P]

#: library name -> its CUDA source, and the C entry points it exports with
#: each one's argument types
KERNELS = {
    "paged_attention": ("paged_attention.cu", {"atpu_paged_decode": _PAGED_ARGS}),
    "paged_prefill": ("paged_prefill.cu", {"atpu_paged_prefill": _PAGED_ARGS}),
    "flash_fwd": ("flash_fwd.cu", {"atpu_flash_fwd": _FWD_ARGS}),
    "flash_bwd": ("flash_bwd.cu", {"atpu_flash_dq": _DQ_ARGS,
                                   "atpu_flash_dkv": _DKV_ARGS}),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Optional[Dict[str, ctypes.CDLL]] = None

#: wall seconds the last :func:`load` spent compiling (0.0 when cached)
build_seconds = 0.0
#: ``nvcc -Xptxas -v`` output of the last build, per library
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _build_all(tag: str) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outputs = {name: BUILD_DIR / f"lib{name}_{tag}.so" for name in KERNELS}
    missing = {name: out for name, out in outputs.items() if not out.exists()}
    if not missing:
        build_seconds = 0.0
        return outputs
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return outputs


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; cached per process."""
    global _libs
    if _libs is not None:
        return _libs
    libs = {}
    for name, path in _build_all(_source_hash()).items():
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in KERNELS[name][1].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.atpu_error_string.argtypes = [ctypes.c_int]
        lib.atpu_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    _libs = libs
    return libs


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return lib.atpu_error_string(code).decode()


def launch(library: str, entry: str, what: str, *args) -> None:
    """Call C entry point ``entry`` of ``library`` (building the libraries at
    first use) and raise with the CUDA error string when it does not return
    0 — a launch refused for its shared memory or grid never runs, and no
    later synchronisation would report it."""
    lib = load()[library]
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed: {error_string(lib, rc)} "
                           f"(cudaError {rc})")
