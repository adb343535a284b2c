"""ctypes bindings of the native host batch ops (``native/batchops.cpp``),
counterpart of ``cotnet_tpu/data/native.py``.

The library is built with g++ at first use, with the JAX module's flags,
into ``cotnet_tpu_torch/_build/libbatchops-<hash>.so`` (the hash covers the
source and the flags): under a temporary name first, then moved into place
with ``os.replace``, so a process that loads it never sees a half-written
file, even while another builds it.  ``available()`` is False where g++ or
the source is missing; the loader then keeps the numpy collate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "batchops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatchops-{digest}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp.so")
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _lib = False
        if not SOURCE.exists():
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            return _lib
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return _lib
        lib.batch_crop_resize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.batch_crop_resize_u8.restype = None
        lib.batch_collate_u8.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int]
        lib.batch_collate_u8.restype = None
        lib.hflip_u8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.hflip_u8.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return bool(_load())


def _require():
    lib = _load()
    if not lib:
        raise RuntimeError(f"native batchops unavailable: {CXX} could not "
                           f"build {SOURCE}")
    return lib


def batch_crop_resize(images: List[np.ndarray],
                      boxes: List[Tuple[int, int, int, int]],
                      out_size: Tuple[int, int],
                      num_threads: int = 8) -> np.ndarray:
    """Crop box (x, y, w, h) from each uint8 HWC image and bilinear-resize to
    out_size (oh, ow); returns one NHWC uint8 batch."""
    lib = _require()
    n = len(images)
    oh, ow = out_size
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im, (x, y, w, h) in zip(images, boxes):
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"want uint8 HWC images with 3 channels, got "
                             f"{im.shape}")
        if not (0 <= x and 0 <= y and w > 0 and h > 0
                and x + w <= im.shape[1] and y + h <= im.shape[0]):
            raise ValueError(f"box {(x, y, w, h)} outside {im.shape[:2]}")
    dst = np.empty((n, oh, ow, 3), np.uint8)
    srcs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in images])

    def ints(vals):
        return (ctypes.c_int * n)(*vals)

    lib.batch_crop_resize_u8(
        srcs,
        ints([im.shape[0] for im in images]),
        ints([im.shape[1] for im in images]),
        ints([b[0] for b in boxes]), ints([b[1] for b in boxes]),
        ints([b[2] for b in boxes]), ints([b[3] for b in boxes]),
        dst.ctypes.data_as(ctypes.c_void_p), n, oh, ow, num_threads)
    return dst


def batch_collate(images: List[np.ndarray], num_threads: int = 8,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Parallel NHWC collation of equal-size uint8 HWC images, into ``out``
    (a C-contiguous uint8 array of shape ``[n, *image.shape]``, for example
    the numpy view of a pinned host tensor) where given."""
    lib = _require()
    n = len(images)
    images = [np.ascontiguousarray(im) for im in images]
    shape = (n, *images[0].shape)
    if any(im.shape != shape[1:] or im.dtype != np.uint8 for im in images):
        raise ValueError("batch_collate wants uint8 images of one shape")
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (out.shape != shape or out.dtype != np.uint8
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous uint8 {shape}, got "
                         f"{out.dtype} {out.shape}")
    srcs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    lib.batch_collate_u8(srcs, out.ctypes.data_as(ctypes.c_void_p), n,
                         int(np.prod(shape[1:])), num_threads)
    return out


def hflip_inplace(img: np.ndarray) -> np.ndarray:
    """Flip a C-contiguous uint8 HWC (3 channels) image left-right in place."""
    lib = _require()
    if not (img.flags["C_CONTIGUOUS"] and img.dtype == np.uint8
            and img.ndim == 3 and img.shape[2] == 3):
        raise ValueError("hflip_inplace wants a C-contiguous uint8 HWC image")
    lib.hflip_u8(img.ctypes.data_as(ctypes.c_void_p), img.shape[0],
                 img.shape[1])
    return img
