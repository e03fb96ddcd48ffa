"""Build and load the hand-written CUDA kernels of this package.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, and the objects are linked into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in ``_build/`` next to this file,
named by a hash of every source, header and flag, so an edit to any of them
rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
COMPILE_FLAGS = ARCH_FLAGS + ["-Xptxas", "-v", "-c"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_LIB = None
BUILD_LOG = ""      # nvcc's output (ptxas register/spill report) of the build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the quant_matmul CUDA kernels "
                           "are built at first use and need the CUDA toolkit")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, bool]:
    """Compile ``csrc/*.cu`` into one library unless a build of these exact
    sources exists; returns the library's path and whether nvcc ran. Raises
    with nvcc's output on a failed build."""
    global BUILD_LOG
    out = BUILD_DIR / f"libquant_matmul_{_digest()}.so"
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            logs.append(f"== {src.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed to build {failed}:\n{BUILD_LOG}")
        lib = Path(tmp) / out.name
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {out.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out, True


def ptxas_report(log: str) -> list:
    """One line per compiled kernel of an nvcc ``-Xptxas -v`` log: its
    (mangled) name, registers and spill bytes."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return lines


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, declaring the C
    signatures. Cached for the life of the process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.sgmv_fused_launch.argtypes = (
        [ptr, i32]                       # x, x_is_bf16
        + [ptr] * 12                     # A_hi B_hi A_lo B_lo codes/scale/zero
        + [ptr, ptr]                     # seg_map, out
        + [i32] * 7                      # T K M NA r_hi r_lo kt
        + [i32] * 6                      # bits/binary of A_hi, B_hi, lo
        + [i32] * 12                     # group/ng/wpg of A_hi B_hi A_lo B_lo
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    lib.sgmv_rhs_launch.argtypes = (
        [ptr, i32]                       # x, x_is_bf16
        + [ptr] * 5                      # codes, scale, zero, seg_map, out
        + [i32] * 10                     # T K R NA kt bits binary group ng wpg
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    lib.sgmv_out_launch.argtypes = (
        [ptr] * 6                        # h, codes, scale, zero, seg_map, out
        + [i32] * 10                     # T R M NA kt bits binary group ng wpg
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    lib.matmul_rhs_launch.argtypes = (
        [ptr, i32]                       # x, x_is_bf16
        + [ptr] * 4                      # codes, scale, zero, out
        + [i32] * 8                      # T K R bits binary group ng wpg
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    lib.matmul_out_launch.argtypes = (
        [ptr] * 5                        # h, codes, scale, zero, out
        + [i32] * 8                      # T R Mp bits binary group ng wpg
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    lib.fused_lora_launch.argtypes = (
        [ptr, i32]                       # x, x_is_bf16
        + [ptr] * 12                     # A_hi B_hi A_lo B_lo codes/scale/zero
        + [ptr]                          # out
        + [i32] * 9                      # T K M r_hi r_lo bits/binary hi, lo
        + [i32] * 12                     # group/ng/wpg of A_hi B_hi A_lo B_lo
        + [i32p]                         # the cluster plan (ClusterPlan.c_args)
        + [ptr])                         # stream
    for fn in (lib.sgmv_fused_launch, lib.sgmv_rhs_launch,
               lib.sgmv_out_launch, lib.matmul_rhs_launch,
               lib.matmul_out_launch, lib.fused_lora_launch):
        fn.restype = i32
    lib.quant_matmul_error_string.argtypes = [i32]
    lib.quant_matmul_error_string.restype = ctypes.c_char_p
    lib.quant_matmul_layout_bytes.argtypes = (
        [i32] * 5                        # x_bytes K M r_hi r_lo
        + [i32p, i32p])                  # bits/binary/group/wpg x 4, plan
    lib.quant_matmul_layout_bytes.restype = ctypes.c_longlong
    _LIB = lib
    return lib
