"""Build and bind the Hopper kernels.

Each CUDA source under ``csrc/`` has a plain C interface and compiles, with
``nvcc`` for ``sm_90a``, into its own shared library under ``build/`` at the
root of the checkout; :func:`library` loads it with ``ctypes``. A library is
rebuilt when its source is newer. :func:`build` compiles every stale source
at once, one ``nvcc`` process per source, and returns what ``ptxas`` said
about each kernel (registers, shared memory, spills).

Nothing here runs at import: the CPU tests import every module, and a CPU
machine has neither ``nvcc`` nor a card. A failed build raises.

``LAUNCHES`` counts, per kernel, the launches the wrappers made. A wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {"spmv": "spmv.cu", "spmm": "spmm.cu", "sddmm": "sddmm.cu",
           "spmttkrp": "spmttkrp.cu", "spadd3": "spadd3.cu",
           "bcsr": "bcsr.cu", "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "spmv_csr_rows": 0, "spmv_coo_nnz": 0, "spmm_csr_rows": 0,
    "spmm_coo_nnz": 0,
    "sddmm_coo": 0, "spmttkrp_coo": 0,
    "spadd3_dense_rows": 0, "bcsr_spadd3_dense_rows": 0,
    "spadd3_union_rows": 0, "bcsr_spadd3_union_rows": 0,
    "spadd3_union_nnz": 0, "bcsr_spadd3_union_nnz": 0,
    "bcsr_spmv": 0, "bcsr_spmm": 0, "bcsr_sddmm": 0, "flash_attention": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    return (not out.exists()
            or out.stat().st_mtime < (CSRC / SOURCES[name]).stat().st_mtime)


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> Dict[str, str]:
    """Compile the named sources (all by default) that are stale, or all of
    them with ``force``, in parallel. Returns {name: nvcc/ptxas output}."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built first if stale), with
    ``argtypes`` set from ``signatures`` and ``restype`` int (the C
    functions return ``cudaGetLastError()``)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def on_cpu(kernel: str, indices: Dict[str, torch.Tensor],
           values: Dict[str, torch.Tensor]) -> bool:
    """Check what a kernel takes, on every device: int32 ``indices``,
    float32 ``values``, all contiguous and on one device. Returns True when
    that device is the CPU (the wrapper then runs the plain version) and
    False for a CUDA device; raises for any other."""
    for want, group in ((torch.int32, indices), (torch.float32, values)):
        for name, t in group.items():
            if t.dtype != want:
                raise TypeError(
                    f"{kernel}: {name} must be {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: {name} must be contiguous")
    devices = {t.device for g in (indices, values) for t in g.values()}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: inputs must all lie on one CUDA device "
                         f"or all on the CPU, got {sorted(map(str, devices))}")
    return False


def check_launch(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[kernel] += 1
