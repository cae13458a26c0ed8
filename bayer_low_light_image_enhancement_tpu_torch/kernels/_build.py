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
    # B, H, W, info (5 long longs)
    "blle_bayer_pack_info": [_I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    # x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ctas, stream
    "blle_gram_pass": [_P] * 7 + [_I] * 5 + [_P],
    # x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2,
    # ybuf, out, B, H, W, C, grid1, grid2, stream
    "blle_apply_pass": [_P] * 15 + [_I] * 6 + [_P],
    # kind, C, info (5 long longs)
    "blle_block_kernel_info": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
    # x (H + 4 rows), wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ctas,
    # bands, frame_h, stream
    "blle_gram_pass_banded": [_P] * 7 + [_I] * 7 + [_P],
    # x (H + 4 rows), apply, ..., bp2, ybuf (H + 2 rows), out, B, H, W, C,
    # grid1, grid2, bands, frame_h, stream
    "blle_apply_pass_banded": [_P] * 15 + [_I] * 8 + [_P],
    # x, dy, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2t, wp1t,
    # op_v, op_y, op_dt, op_g (NULL below the split width), workspace, dx2,
    # dapply, dw, B, H, W, C, stream
    "blle_bwd1": [_P] * 22 + [_I] * 4 + [_P],
    # x, dx2, applyt, dgramt, dgram, dss, wqk, bqk, dwqk, bdwqk, wv, bv, dwv,
    # bdwv, wqkvt, op_x, op_dz (NULL below the split width), workspace, dx,
    # dw, B, H, W, C, stream
    "blle_bwd2": [_P] * 20 + [_I] * 4 + [_P],
    # the problem table (11 long longs per product), products, tile width,
    # cluster, stream
    "blle_weight_grad": [ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, _P],
    # tile width, cluster, info (4 long longs)
    "blle_weight_grad_info": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
    # u, dt, A, B, C, D, y, states (or NULL), hend, sdt (NULL for one chunk),
    # B, L, D, N, chunk, in_bf16, stream
    "blle_ssm_fwd": [_P] * 10 + [_I] * 6 + [_P],
    # u, dt, A, B, C, D, dy, states, du, ddt, dA, dB, dC, dD, workspace, B, L,
    # D, N, chunk, dgroup, in_bf16, stream
    "blle_ssm_bwd": [_P] * 15 + [_I] * 7 + [_P],
    # dgroup, in_bf16 (returns blocks per SM, not an error code)
    "blle_ssm_bwd_blocks_per_sm": [_I, _I],
    # in_bf16 (returns blocks per SM, not an error code)
    "blle_ssm_fwd_blocks_per_sm": [_I],
    # x ... bp2, out, B, H, W, C, grid, stream (blle_apply_pass without ybuf,
    # one grid)
    "blle_apply_pipelined": [_P] * 14 + [_I] * 5 + [_P],
    # x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ctas, stream
    "blle_attn_gram": [_P] * 7 + [_I] * 5 + [_P],
    # sums, temperature, wproj, apply, B, C, heads, stream
    "blle_attn_finalize": [_P] * 4 + [_I] * 3 + [_P],
    # x, apply, wv, bv, dwv, bdwv, bproj, out, B, H, W, C, grid, stream
    "blle_attn_apply": [_P] * 8 + [_I] * 5 + [_P],
    # x, t, w1 (taps, wr1, wr2), bc, br, w2 (taps), bo, ybuf, out, B, H, W, C,
    # grid1, grid2, stream
    "blle_stage_tail": [_P] * 9 + [_I] * 6 + [_P],
    # kind, C, info (10 long longs)
    "blle_stage_tail_info": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
    # x ... bp2, ybuf, out, B, H, W, C, stage, pipelined, stream
    "blle_probe_apply_cut": [_P] * 15 + [_I] * 6 + [_P],
    # x, w, dw, out, B, H, W, C, strategy, level, th, stream
    "blle_probe_floor": [_P] * 4 + [_I] * 7 + [_P],
    # x, out, B, HX, first row, rows, W, C, stream
    "blle_wide_layernorm": [_P, _P] + [_I] * 6 + [_P],
    # the product's table (20 long longs, wide_block.gemm), stream
    "blle_wide_gemm": [ctypes.POINTER(ctypes.c_longlong), _P],
    # tile width, info (4 long longs)
    "blle_wide_gemm_info": [_I, ctypes.POINTER(ctypes.c_longlong)],
    # z, taps, bias, out0, out1, partials, B, RZ, RO, dz, W, F, epilogue,
    # bands, hb, frame_h, stream
    "blle_wide_dw": [_P] * 6 + [_I] * 10 + [_P],
    # gram, partials, out, B, C, nx, stream
    "blle_wide_gram_finish": [_P] * 3 + [_I] * 3 + [_P],
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
    # (G, K, M, N, slices) per product, products, cluster
    "blle_weight_grad_workspace_floats": [ctypes.POINTER(ctypes.c_longlong), _I, _I],
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


# PyTorch's raw accessor of the current stream (what Triton launches on):
# the same handle as torch.cuda.current_stream(device).cuda_stream without
# building a Stream object, a few microseconds a launch. CUDA builds only.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream
