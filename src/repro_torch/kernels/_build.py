"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

The sources are compiled at first use on a CUDA tensor, never at import:
one ``nvcc -c`` per ``.cu`` file, all started together, then one link into
a shared library with a plain C interface that :mod:`ctypes` loads. The
library lands in ``build/repro_torch/<hash>/`` at the root of the checkout
(listed in ``.gitignore``), keyed by a hash of the sources and the flags,
so an edited kernel is rebuilt and an unchanged one is reused. The build
reads only this package's sources and needs ``nvcc`` (CUDA 12, ``sm_90a``).
``NVCC_FLAGS`` (part of the hash) hold ``-Xptxas -v``: ptxas reports each
kernel's registers, stack and spills, and :func:`library` keeps that report
beside the library as ``ptxas.log`` (read it with :func:`ptxas_report`).
The tensor-map encoder that the bf16 Hopper attention kernel needs is looked up
in the driver at run time, so nothing links against ``libcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
# the attention entry points' arguments before the stream: q, k, v, out, B,
# H, group, S, D, q's and k's (batch, head, position) strides, scale,
# causal, window, has_window
_FLASH = (_P, _P, _P, _P, *(ctypes.c_int,) * 5, *(ctypes.c_int64,) * 6,
          ctypes.c_float, *(ctypes.c_int,) * 3)
_SIGNATURES = {
    # name: argtypes (every entry point returns cudaError_t as an int)
    "repro_sumsq": (_P, ctypes.c_int, ctypes.c_int64, _P, ctypes.c_int, _P,
                    _P),
    "repro_scale_accumulate": (_P, _P, ctypes.c_int, _P, _P, ctypes.c_int64,
                               _P),
    "repro_sumsq_rows": (_P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_int64, _P, ctypes.c_int, _P, _P),
    "repro_clip_accumulate_rows": (_P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int64, ctypes.c_int64, _P, _P,
                                   _P),
    "repro_noise_adam_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              ctypes.c_int64, *(ctypes.c_float,) * 9,
                              ctypes.c_int, _P),
    "repro_pushsum_mix": (_P, ctypes.c_int, _P, _P, _P, ctypes.c_int,
                          ctypes.c_int64, ctypes.c_int, _P),
    "repro_pushsum_mix_blocks": (_P, ctypes.c_int, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                 _P),
    "repro_stale_mix": (_P, _P, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                        ctypes.c_int, ctypes.c_int64, _P),
    "repro_noise_sgd_step": (_P, _P, _P, ctypes.c_int, _P, ctypes.c_int64,
                             *(ctypes.c_float,) * 4, ctypes.c_int, _P),
    "repro_rmsnorm": (_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int, _P),
    "repro_flash_attention_sm90": (*_FLASH, _P),
    "repro_flash_attention_tf32x3": (*_FLASH, _P),
    # the narrow loaders take the bytes a copy last
    "repro_flash_attention_sm90_narrow": (*_FLASH, ctypes.c_int, _P),
    "repro_flash_attention_tf32x3_narrow": (*_FLASH, ctypes.c_int, _P),
    # dt, x, B, C (each with its dtype code), A, y, h0, hlast (NULL: from
    # zero, no final state), B, S, di, ds
    "repro_mamba_scan": (_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
                         _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                         ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built with the CUDA toolkit at first use on a GPU")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    """Compile every source in parallel, link them, return the library."""
    nvcc = _nvcc()
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cu, obj in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(cu.name, log) for cu, p, log in zip(cus, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        (out_dir / "ptxas.log").write_text("".join(
            f"--- {cu.name}\n{log}" for cu, log in zip(cus, logs)))
        tmp_lib = Path(tmp) / "librepro_kernels.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        lib = out_dir / tmp_lib.name
        os.replace(tmp_lib, lib)  # atomic: concurrent builds agree
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        out_dir = BUILD_ROOT / _digest()
        lib_path = out_dir / "librepro_kernels.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _compile(out_dir)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ptxas_report():
    """(kernel, registers, spill store bytes, spill load bytes, stack bytes)
    for every kernel of the built library, from ptxas's ``-v`` report; the
    kernel is its mangled name."""
    library()
    rows, name, spill = [], None, None
    log = (BUILD_ROOT / _digest() / "ptxas.log").read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            n = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
            spill = n[:3]   # stack frame, spill stores, spill loads
        elif "Used" in line and "registers" in line and name and spill:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((name, regs, spill[1], spill[2], spill[0]))
            name, spill = None, None
    return rows


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream; raise on error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad (also inside
    a ``torch.func`` transform): a kernel's output carries no autograd
    history, so the gradient through it would be cut without a word. A
    differentiated forward runs the model's plain path instead. Checked
    before the dispatch, on the CPU's plain versions too."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the kernel has no backward "
            "and would cut the gradient. Differentiate the plain path "
            "(use_pallas=False), or call the kernel under torch.no_grad()")


def check_cuda(name: str, *tensors: torch.Tensor,
               contiguous: bool = True) -> None:
    """Every tensor on the current CUDA device and, unless the caller
    checks strides itself (``contiguous=False``), contiguous."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.type != "cuda" or t.device.index != dev:
            raise ValueError(f"{name}: tensor on {t.device}, expected the "
                             f"current CUDA device cuda:{dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
