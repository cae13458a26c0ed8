"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface, loaded with ``ctypes`` (seconds per build, where
``torch.utils.cpp_extension.load`` takes minutes because it compiles
PyTorch's headers). The library lands in ``_build/`` inside the package,
named by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the file. The build happens at the first kernel
launch, never at import.

Every pointer and stream argument is declared ``c_void_p`` (ctypes would
otherwise pass a Python int as a 32-bit C int and cut the pointer). Each C
entry point returns the ``cudaError_t`` of its launches; the wrappers raise
when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills into the build log
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argument types (every entry point returns an int cudaError_t).
_SIGNATURES = {
    # mosaic, ratio, out, B, H, W, out_bf16, clamp01, stream
    "blle_bayer_pack": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, stream
    "blle_gram_pass": [_P] * 7 + [_I] * 4 + [_P],
    # x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2,
    # out, B, H, W, C, stream
    "blle_apply_pass": [_P] * 14 + [_I] * 4 + [_P],
    # x, dy, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2t, wp1t,
    # workspace, dx2, dapply, dw, B, H, W, C, stream
    "blle_bwd1": [_P] * 18 + [_I] * 4 + [_P],
    # x, dx2, applyt, dgramt, dgram, dss, wqk, bqk, dwqk, bdwqk, wv, bv, dwv,
    # bdwv, wqkvt, workspace, dx, dw, B, H, W, C, stream
    "blle_bwd2": [_P] * 18 + [_I] * 4 + [_P],
    # u, dt, A, B, C, D, y, states (or NULL), hbuf, sbuf, B, L, D, N, chunk,
    # in_bf16, stream
    "blle_ssm_fwd": [_P] * 10 + [_I] * 6 + [_P],
    # u, dt, A, B, C, D, dy, states, du, ddt, dA, dB, dC, dD, workspace, B, L,
    # D, N, chunk, dgroup, in_bf16, stream
    "blle_ssm_bwd": [_P] * 15 + [_I] * 7 + [_P],
    # the arguments of blle_apply_pass
    "blle_apply_pipelined": [_P] * 14 + [_I] * 4 + [_P],
    # x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, stream
    "blle_attn_gram": [_P] * 7 + [_I] * 4 + [_P],
    # x, apply, wv, bv, dwv, bdwv, bproj, out, B, H, W, C, stream
    "blle_attn_apply": [_P] * 8 + [_I] * 4 + [_P],
    # x, t, wc, bc, wr1, wr2, br, wo, bo, out, B, H, W, C, stream
    "blle_stage_tail": [_P] * 10 + [_I] * 4 + [_P],
    # the arguments of blle_apply_pass but the stream, stage, pipelined, stream
    "blle_probe_apply_cut": [_P] * 14 + [_I] * 6 + [_P],
    # x, w, dw, out, B, H, W, C, strategy, level, th, stream
    "blle_probe_floor": [_P] * 4 + [_I] * 7 + [_P],
}
# name -> argument types of the size queries (each returns a long long).
_SIZES = {
    "blle_gram_workspace_floats": [_I] * 4,  # B, H, W, C
    "blle_attn_gram_workspace_floats": [_I] * 4,
    "blle_bwd1_workspace_floats": [_I] * 4,
    "blle_bwd2_workspace_floats": [_I] * 4,
    "blle_bwd1_grad_floats": [_I],  # C
    "blle_bwd2_grad_floats": [_I],
    "blle_ssm_bwd_workspace_floats": [_I] * 6,  # B, L, D, N, chunk, dgroup
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libblle_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. The compiler's output (with ``-Xptxas -v``) is kept beside it as
    ``<library>.log``. Raises RuntimeError if nvcc is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    cus, _ = _sources()
    if not cus:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    tmp = so.with_name(f"{tag}.so.tmp")
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)] for o, cu in zip(objs, cus)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, failed = "", False
    for c, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log += f"$ {' '.join(c)}\n{out}returncode {proc.returncode}\n"
        failed |= proc.returncode != 0
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += f"$ {' '.join(link)}\n{proc.stdout}returncode {proc.returncode}\n"
        failed = proc.returncode != 0
    log += f"{time.perf_counter() - t0:.1f} s\n"
    Path(f"{so}.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    lib.blle_error_string.argtypes = [_I]
    lib.blle_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().blle_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
