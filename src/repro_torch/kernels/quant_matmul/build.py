"""Build and load the hand-written CUDA kernels of this package.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in ``_build/`` next to
this file, named by a hash of the source and flags, so an edited source
rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_LOG = ""      # nvcc's output (ptxas register/spill report) of the build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the sgmv_fused CUDA kernel is "
                           "built at first use and needs the CUDA toolkit")
    return found


def build_library() -> tuple[Path, bool]:
    """Compile ``csrc/sgmv_fused.cu`` unless a build of this exact source
    exists; returns the library's path and whether nvcc ran. Raises with
    nvcc's output on a failed build."""
    global BUILD_LOG
    src = CSRC / "sgmv_fused.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"libsgmv_fused_{digest}.so"
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{BUILD_LOG}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, True


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, declaring the C
    signatures. Cached for the life of the process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sgmv_fused_launch.argtypes = (
        [ptr, i32]                       # x, x_is_bf16
        + [ptr] * 6                      # A_hi, B_hi codes/scale/zero
        + [ptr] * 4                      # A_lo, B_lo codes/scale
        + [ptr, ptr]                     # seg_map, out
        + [i32] * 7                      # T K M NA Rp kt bits
        + [i32] * 8                      # group/ng/wpg of the A and B sides
        + [ptr])                         # stream
    lib.sgmv_fused_launch.restype = i32
    lib.sgmv_fused_error_string.argtypes = [i32]
    lib.sgmv_fused_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
