"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface, ``cotnet_tpu_torch/_build/lib<name>-<hash>.so``.  The hash covers
the source, the headers beside it (``csrc/*.cuh``, which any source may
include) and the compiler flags, so an edited source builds anew and an
unchanged one loads the library already there.  The sources in the package
are the only inputs; nothing is built or run when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built at first use "
            "and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    inputs = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in inputs)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> List[str]:
    """The names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` (all of them by default) that is not
    built already, one ``nvcc`` per source, all started together.  Returns
    each compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills), empty where the library was there."""
    outputs, running = {}, []
    for name in (sources() if names is None else names):
        so = library_path(name)
        if so.exists():
            outputs[name] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in running:
        outputs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{outputs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outputs


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    compiler's output."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
