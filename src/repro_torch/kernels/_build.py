"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds; the
``nvcc`` of each source starts at once and they run in parallel. The
library lands under the repository's ``build/`` directory, keyed by a
hash of the sources and flags, and is built at first use with a CUDA
tensor — importing any module of the port never needs ``nvcc``.

A failed build raises with ``nvcc``'s output; there is no fallback.
:func:`refuse_grad` is the check every wrapper of a kernel without a
backward makes before it launches.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["build", "load", "kernel_function", "check", "refuse_grad", "BuildInfo",
           "sass_by_function", "sass_opcodes", "sass_mma_counts", "tensor_core_check",
           "TENSOR_CORE_KERNELS", "TF32_KERNELS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The bf16 instantiations of the prefill-attention kernels, which run on
# the tensor cores (csrc/attention_tc.cuh): kernel name -> instantiations
# (head width 64 / 128; paged also bf16 / int8 pools).
TENSOR_CORE_KERNELS = {"flash_fwd_tc_kernel": 2, "paged_prefill_tc_kernel": 4}
# The fp32-compute flash forward (its P V; fp32 at head width 64 / 128, fp32
# and bf16 at 8 / 16 in one- and four-warp blocks) and the backward's product
# kernels (8 / 16 / 64 / 128), which run their products as 3xTF32 mma.sync
# (csrc/tf32x3.cuh): kernel name -> instantiations.
TF32_KERNELS = {"flash_fwd_kernel": 10, "flash_bwd_dkdv_kernel": 4, "flash_bwd_dq_kernel": 4}

_lib: ctypes.CDLL | None = None  # the process's loaded kernel library


class BuildInfo:
    """Where the library is, how long its build took (0 = cached), and
    ``nvcc``'s output (register / shared-memory use per kernel)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``libkernels.so`` unless this exact
    source set is already built."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libkernels.so"
    log_path = out_dir / "build.log"
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, log_path.read_text() if log_path.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / "libkernels.so"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp_lib), *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{log}")
        log_path.write_text(log)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent build sees all or nothing
    return BuildInfo(lib_path, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument types declared
    (``c_void_p`` for every pointer and the stream) and an int return:
    the entry's ``cudaGetLastError()``."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise if autograd would record the kernel's result.

    A kernel writes its output through a raw pointer into a fresh tensor,
    which autograd sees as a constant: under grad, every input that needs a
    gradient would silently get none through this call. A wrapper whose
    kernel has no backward calls this before it launches.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "run it under torch.no_grad(), or train a model whose path has one"
        )


def sass_by_function(lib: Path) -> dict[str, str]:
    """The library's ``cuobjdump -sass`` split per kernel function: mangled
    name -> its SASS."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return dict(block.split(None, 1) for block in sass.split("Function : ")[1:])


def sass_opcodes(body: str) -> dict[str, int]:
    """Opcode histogram of one function's SASS (the mnemonic before the
    first '.', predicates skipped), most frequent first."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body)
    return dict(collections.Counter(ops).most_common())


def sass_mma_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Per kernel function of the library, by mangled name, its wgmma
    (``hgmma``) and mma.sync (``hmma``; of them on TF32 operands,
    ``hmma_tf32``) instructions in ``cuobjdump -sass``, its fp32 FMAs on the
    CUDA cores (``ffma``) and its ``MUFU.EX2`` (exp2 on the
    special-function units)."""
    return {name: {"hgmma": body.count("HGMMA"), "hmma": body.count("HMMA"),
                   "hmma_tf32": len(re.findall(r"HMMA\.[\w.]*TF32", body)),
                   "ffma": body.count("FFMA"), "mufu_ex2": body.count("MUFU.EX2")}
            for name, body in sass_by_function(lib).items()}


def tensor_core_check(counts: dict[str, dict[str, int]], kernels: dict[str, int] | None = None,
                      key: str = "hgmma") -> dict[str, dict[str, int]]:
    """The ``key`` count (default HGMMA) of every instantiation of
    ``kernels`` (default ``TENSOR_CORE_KERNELS``; ``TF32_KERNELS`` with
    ``key="hmma_tf32"``) in ``counts`` (keyed by mangled or readable name);
    raises unless each kernel has all its instantiations and each holds
    such instructions."""
    found = {}
    for kernel, n in (TENSOR_CORE_KERNELS if kernels is None else kernels).items():
        held = {name: c[key] for name, c in counts.items() if kernel in name}
        if len(held) != n or not all(held.values()):
            raise RuntimeError(f"{kernel}: {n} instantiations with {key} expected, SASS has {held}")
        found[kernel] = held
    return found
