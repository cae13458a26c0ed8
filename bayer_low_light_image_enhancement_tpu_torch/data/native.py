"""ctypes bridge to the native C++ batch-assembly engine.

Port of ``bayer_low_light_image_enhancement_tpu/data/native.py`` with the
same functions and the same random draws, so that one seed gives the same
batches as the JAX package's engine. The source is the port's own copy,
``csrc/bayer_pipeline.cpp`` (plain C ABI, host threads; not a GPU kernel).

It is built with ``g++`` on first use, never at import, into the package's
``_build/`` as ``libbayer_pipeline_<hash>.so`` (a hash of the source, the
flags and the machine type), under a file lock and through a temporary name
moved into place, so that processes starting together build it once and
never load a torn file. ``native_available()`` gates the fast path; the
numpy route (``Loader`` over ``dataset.sample``) stays the reference.

Python draws the augmentation (crop offsets, flips, as the reference's
``load_dataset.py``); C++ does the parallel crop / flip / normalise / gather
into the batch buffer.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from bayer_low_light_image_enhancement_tpu_torch.data.sid import sid_ratio_from_filename

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bayer_pipeline.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
THREADS = 8  # host threads of each engine call
PREFETCH = 4  # batches NativeLoader's producer keeps ahead

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None

_U16P = ctypes.POINTER(ctypes.c_uint16)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int
# The C entry points' arguments (each returns an int status).
_SIGNATURES = {
    # mosaics, gts (float), hs, ws, ci, cj, flip_lr, flip_ud, ratios, batch, patch,
    # out_raw, out_gt, threads
    "bp_assemble_batch": [ctypes.POINTER(_U16P), ctypes.POINTER(_F32P), _I32P, _I32P, _I32P,
                          _I32P, _U8P, _U8P, _F32P, _I, _I, _F32P, _F32P, _I],
    # mosaics, gts (uint16), ..., out_raw_u16, out_gt16, threads
    "bp_assemble_batch_u16gt": [ctypes.POINTER(_U16P), ctypes.POINTER(_U16P), _I32P, _I32P,
                                _I32P, _I32P, _U8P, _U8P, _F32P, _I, _I, _U16P, _U16P, _I],
    # gt16, out, n, threads
    "bp_gt_to_float": [_U16P, _F32P, ctypes.c_int64, _I],
}


def library_path() -> Path:
    """Where the library for the current source, flags and machine lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + [platform.machine()]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbayer_pipeline_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless its library exists; returns its path.
    Raises RuntimeError when g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native batch engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "bayer_pipeline.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ invocation failed: {e}") from None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed: {res.stderr[:2000]}")
        os.replace(tmp, so)
    return so


def _load():
    """The loaded library, or None (the build error kept) when it cannot be
    built."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError:  # a library built on another host: build it here
                library_path().unlink(missing_ok=True)
                lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native pipeline unavailable: {_build_error}")
    return lib


def _draw_args(crops: np.ndarray, flips: np.ndarray):
    ci = np.ascontiguousarray(crops[:, 0], np.int32)
    cj = np.ascontiguousarray(crops[:, 1], np.int32)
    flr = np.ascontiguousarray(flips[:, 0], np.uint8)
    fud = np.ascontiguousarray(flips[:, 1], np.uint8)
    return ci, cj, flr, fud


def _check_batch(batch: int, *per_sample) -> None:
    if any(len(a) != batch for a in per_sample):
        raise ValueError(f"per-sample arguments of lengths {[len(a) for a in per_sample]} for "
                         f"{batch} mosaics")


def _frames(mosaics, gts, gt_dtype, gt_ptr):
    """Pointer arrays and sizes of the batch's source frames."""
    batch = len(mosaics)
    mos_ptrs = (_U16P * batch)()
    gt_ptrs = (gt_ptr * batch)()
    hs = (ctypes.c_int * batch)()
    ws = (ctypes.c_int * batch)()
    for i, (m, g) in enumerate(zip(mosaics, gts)):
        if not (m.dtype == np.uint16 and m.ndim == 2 and m.flags.c_contiguous):
            raise ValueError(f"mosaic {i}: want a C-contiguous uint16 [h, w], got {m.dtype} "
                             f"{m.shape}")
        if not (g.dtype == gt_dtype and g.shape == m.shape + (3,) and g.flags.c_contiguous):
            raise ValueError(f"gt {i}: want a C-contiguous {np.dtype(gt_dtype)} {m.shape + (3,)}"
                             f", got {g.dtype} {g.shape}")
        mos_ptrs[i] = m.ctypes.data_as(_U16P)
        gt_ptrs[i] = g.ctypes.data_as(gt_ptr)
        hs[i], ws[i] = m.shape[0], m.shape[1]
    return mos_ptrs, gt_ptrs, hs, ws


def assemble_batch(
    mosaics: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    crops: np.ndarray,      # [B, 2] even (ci, cj)
    flips: np.ndarray,      # [B, 2] bool (lr, ud)
    ratios: np.ndarray,     # [B]
    patch: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble a (raw, gt) batch.

    mosaics[i]: uint16 [h, w]; gts[i]: float32 [h, w, 3] in [0, 1].
    Returns raw [B, p, p, 1] float32 (normalised, amplified) and gt
    [B, p, p, 3] float32.
    """
    lib = _library()
    batch = len(mosaics)
    _check_batch(batch, gts, crops, flips, ratios)
    mos_ptrs, gt_ptrs, hs, ws = _frames(mosaics, gts, np.float32, _F32P)
    ci, cj, flr, fud = _draw_args(crops, flips)
    rat = np.ascontiguousarray(ratios, np.float32)
    out_gt = np.empty((batch, patch, patch, 3), np.float32)
    out_raw = np.empty((batch, patch, patch, 1), np.float32)
    rc = lib.bp_assemble_batch(
        mos_ptrs, gt_ptrs, hs, ws, ci.ctypes.data_as(_I32P), cj.ctypes.data_as(_I32P),
        flr.ctypes.data_as(_U8P), fud.ctypes.data_as(_U8P), rat.ctypes.data_as(_F32P),
        ctypes.c_int(batch), ctypes.c_int(patch), out_raw.ctypes.data_as(_F32P),
        out_gt.ctypes.data_as(_F32P), ctypes.c_int(THREADS),
    )
    if rc != 0:
        raise RuntimeError(f"bp_assemble_batch failed with code {rc}")
    return out_raw, out_gt


def assemble_batch_compact(
    mosaics: Sequence[np.ndarray],
    gts16: Sequence[np.ndarray],
    crops: np.ndarray,
    flips: np.ndarray,
    patch: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compact assembly: the raw mosaic codes AND the GT stay uint16, so the
    host-to-device copy is 16-bit end to end (5x smaller than the fp32
    batch); ``train.trainer.decode_batch`` decodes them on the device with
    the fp32 expressions the host path evaluates.

    mosaics[i]: uint16 [h, w]; gts16[i]: uint16 [h, w, 3].
    Returns (raw_u16 [B, p, p, 1], gt_u16 [B, p, p, 3]).
    """
    lib = _library()
    batch = len(mosaics)
    _check_batch(batch, gts16, crops, flips)
    mos_ptrs, gt_ptrs, hs, ws = _frames(mosaics, gts16, np.uint16, _U16P)
    ci, cj, flr, fud = _draw_args(crops, flips)
    rat = np.zeros((batch,), np.float32)  # unused by the compact path
    out_raw = np.empty((batch, patch, patch, 1), np.uint16)
    out_gt = np.empty((batch, patch, patch, 3), np.uint16)
    rc = lib.bp_assemble_batch_u16gt(
        mos_ptrs, gt_ptrs, hs, ws, ci.ctypes.data_as(_I32P), cj.ctypes.data_as(_I32P),
        flr.ctypes.data_as(_U8P), fud.ctypes.data_as(_U8P), rat.ctypes.data_as(_F32P),
        ctypes.c_int(batch), ctypes.c_int(patch), out_raw.ctypes.data_as(_U16P),
        out_gt.ctypes.data_as(_U16P), ctypes.c_int(THREADS),
    )
    if rc != 0:
        raise RuntimeError(f"bp_assemble_batch_u16gt failed with code {rc}")
    return out_raw, out_gt


def gt16_to_float(gt16: np.ndarray) -> np.ndarray:
    """uint16 GT -> float32 [0, 1] (parallel x (1/65535); numpy's / 65535
    where the engine is unavailable)."""
    lib = _load()
    if lib is None:
        return np.clip(gt16, 0, 65535).astype(np.float32) / 65535.0
    out = np.empty(gt16.shape, np.float32)
    g = np.ascontiguousarray(gt16, np.uint16)
    lib.bp_gt_to_float(g.ctypes.data_as(_U16P), out.ctypes.data_as(_F32P),
                       ctypes.c_int64(g.size), ctypes.c_int(THREADS))
    return out


def sampler_for_dataset(
    dataset, seed: int = 0, compact: bool = False,
) -> Optional["NativeBatchSampler"]:
    """Adapt an in-RAM training dataset to a :class:`NativeBatchSampler`:

    * ``SIDDataset(preload=True)``: uint16 mosaics in ``_shorts``, uint16
      GTs in ``_longs`` (kept uint16 when ``compact``, else converted once by
      ``gt16_to_float``), per-pair ratios from the GT filenames;
    * ``SyntheticBayerDataset``: ``mosaics`` / ``gts``, one scalar ratio.

    Returns None when the engine cannot be built, the dataset is not a
    training split, its frames are not resident in RAM, or a frame is too
    small for the crop draw (2 rows / columns of slack).
    """
    if not native_available() or not getattr(dataset, "training", False):
        return None
    patch = getattr(dataset, "patch_size", None)
    if not patch:
        return None
    if getattr(dataset, "_shorts", None) is not None:  # SIDDataset, preloaded
        mosaics = dataset._shorts
        if compact:
            gts = [np.ascontiguousarray(g) for g in dataset._longs]
        else:
            gts = [gt16_to_float(g) for g in dataset._longs]
        ratios = [sid_ratio_from_filename(p) for p in dataset.long_paths]
    elif getattr(dataset, "mosaics", None) is not None and getattr(dataset, "gts", None) is not None:
        mosaics, gts = dataset.mosaics, dataset.gts
        if not (mosaics and mosaics[0].dtype == np.uint16 and gts[0].dtype == np.float32):
            return None
        if compact:
            # Synthetic GTs are made in fp32: quantise once to uint16 (SID's
            # are uint16 at the source, where this is exact).
            gts = [np.ascontiguousarray(np.round(np.clip(g, 0.0, 1.0) * 65535.0)
                                        .astype(np.uint16)) for g in gts]
        ratios = [float(getattr(dataset, "ratio", 1.0))] * len(mosaics)
    else:
        return None
    if any(m.shape[0] < patch + 2 or m.shape[1] < patch + 2 for m in mosaics):
        return None
    return NativeBatchSampler(mosaics, gts, ratios, patch, seed=seed, compact=compact)


class NativeLoader:
    """``Loader``-compatible iterator fed by the C++ engine: the same epoch
    and shuffle discipline (a seeded permutation per epoch, the last partial
    batch dropped), with
    one producer thread keeping a small queue of assembled batches ahead."""

    def __init__(self, dataset, sampler: "NativeBatchSampler", batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        n = len(self.dataset)
        order = np.random.default_rng((self.seed, epoch)).permutation(n)
        end = (n // self.batch_size) * self.batch_size
        batches = [order[i : i + self.batch_size] for i in range(0, end, self.batch_size)]

        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(self.sampler.sample_batch([int(i) for i in idxs], epoch))
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    yield item
            finally:
                stop.set()
                while thread.is_alive():  # drain so the producer can exit
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        thread.join(timeout=0.1)

        return gen()


class NativeBatchSampler:
    """Batch sampler over in-RAM frames through the engine: ``mosaics``
    (uint16 [h, w]), ``gts`` (float32 [h, w, 3], or uint16 when
    ``compact``), one ratio per frame.

    ``sample_batch`` returns ``(raw, gt)`` (raw fp32 normalised), or with
    ``compact`` the triple ``(raw_u16 [B,p,p,1], ratio [B], gt_u16
    [B,p,p,3])`` that ``train.trainer.decode_batch`` decodes on the device."""

    def __init__(self, mosaics, gts, ratios, patch_size: int, seed: int = 0,
                 compact: bool = False):
        self.mosaics = mosaics
        self.gts = gts
        self.ratios = np.asarray(ratios, np.float32)
        self.patch = patch_size
        self.seed = seed
        self.compact = compact

    def sample_batch(self, indices: Sequence[int], epoch: int):
        rng = np.random.default_rng((self.seed, epoch, tuple(int(i) for i in indices)))
        batch = len(indices)
        crops = np.empty((batch, 2), np.int32)
        flips = np.empty((batch, 2), np.uint8)
        for s, idx in enumerate(indices):
            h, w = self.mosaics[idx].shape
            crops[s, 0] = int(rng.integers(0, (h - self.patch - 2) // 2 + 1)) * 2
            crops[s, 1] = int(rng.integers(0, (w - self.patch - 2) // 2 + 1)) * 2
            flips[s, 0] = rng.random() < 0.5
            flips[s, 1] = rng.random() < 0.2
        mosaics = [self.mosaics[i] for i in indices]
        gts = [self.gts[i] for i in indices]
        if self.compact:
            raw16, gt16 = assemble_batch_compact(mosaics, gts, crops, flips, self.patch)
            return raw16, self.ratios[list(indices)], gt16
        return assemble_batch(mosaics, gts, crops, flips, self.ratios[list(indices)], self.patch)
