"""Build and load the port's CUDA kernels.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point and loaded with ``ctypes``.  The fused ERK
kernel is specialised per (tableau, right-hand side): a generated header,
``fused_erk_config.cuh``, holds the method's tableau rounded to float32
exactly as the JAX kernel rounds it, as ``constexpr`` arrays, and the
user's CUDA RHS.  The build key hashes the kernel source, that header and
the flags; the library lands in ``extensisq_tpu_torch/_build/<key>/`` at
first use and is reused after.  Nothing is built when this module is
imported.
"""
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
FUSED_ERK_SOURCE = _PKG / "csrc" / "fused_erk.cu"
BUILD_DIR = _PKG / "_build"
# where the CUDA toolkit installs nvcc when it is not on PATH
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

# no -use_fast_math: powf/log10f feed the controller and the start step
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}


@dataclasses.dataclass(frozen=True)
class Built:
    """A loaded kernel library: ``lib`` (ctypes), its build ``key``, the
    seconds ``nvcc`` took in this process (0.0 when it was on disk) and
    the compiler's output (registers, spills) from ``-Xptxas -v``."""
    lib: ctypes.CDLL
    key: str
    seconds: float
    log: str


def _f32(x):
    """A float32 C++ hex literal of ``x`` rounded to float32."""
    v = float(np.float32(x))
    if v == 0.0:
        return "0.0f"
    return float.hex(v) + "f"


def _array(values):
    return "{" + ", ".join(_f32(v) for v in values) + "}"


def fused_erk_header(k, n, rhs_src):
    """Text of ``fused_erk_config.cuh`` for the constants ``k`` of
    ``ops.fused_erk._fused_consts``, state size ``n`` and the CUDA RHS
    source."""
    s = k["s"]
    A = k["A"]
    cc = k["cc"]
    hs = k["hstart"]
    rows = ",\n    ".join(_array(A[i]) for i in range(s))
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// Tableau {k['name']} rounded to float32, and the user's right-hand side.
#pragma once

namespace tab {{
constexpr int N = {n};
constexpr int S = {s};
constexpr bool FSAL = {'true' if k['fsal'] else 'false'};
constexpr int MORDER = {k['morder']};
constexpr float A[S][S] = {{
    {rows}}};
constexpr float B[S] = {_array(k['B'])};
constexpr float C[S] = {_array(k['C'])};
constexpr float E[S + 1] = {_array(k['E'])};
constexpr float SAFETY = {_f32(cc.safety)};
constexpr float SAFETY_SC = {_f32(cc.safety_sc)};
constexpr float MINBETA1 = {_f32(cc.minbeta1)};
constexpr float MINBETA2 = {_f32(cc.minbeta2)};
constexpr float MINALPHA = {_f32(cc.minalpha)};
constexpr float ERROR_EXPONENT = {_f32(cc.error_exponent)};
constexpr float MIN_FACTOR = {_f32(cc.min_factor)};
constexpr float H_MIN_A = {_f32(k['h_min_a'])};
constexpr float TINY_ERR = {_f32(k['tiny_err'])};
constexpr float HS_BIG = {_f32(hs['big'])};
constexpr float HS_SMALL = {_f32(hs['small'])};
constexpr float HS_RELPER = {_f32(hs['relper'])};
constexpr float HS_T_FLOOR = {_f32(hs['t_floor'])};
}}  // namespace tab

{rhs_src}
"""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _compile(source, header, out_dir):
    """nvcc ``source`` (with ``header`` beside it) into out_dir/lib.so;
    returns (seconds, compiler output)."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "fused_erk_config.cuh").write_text(header)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-o", tmp, str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, out_dir / "lib.so")
    return seconds, log


def load_fused_erk(consts, n, rhs_src):
    """Build (at first use) and load the fused ERK kernel for one tableau
    and RHS; returns :class:`Built` with ``lib.fused_erk_launch`` bound."""
    header = fused_erk_header(consts, n, rhs_src)
    source = FUSED_ERK_SOURCE.read_text()
    key = hashlib.sha256("\0".join(
        [source, header, " ".join(NVCC_FLAGS)]).encode()).hexdigest()[:16]
    if key in _LOADED:
        return _LOADED[key]
    out_dir = BUILD_DIR / f"fused_erk_{key}"
    so = out_dir / "lib.so"
    seconds, log = 0.0, ""
    if so.exists():
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _compile(FUSED_ERK_SOURCE, header, out_dir)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_erk_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, vp, vp, vp, vp, ci, cf, cf, cf, cf, cf, ci, cf, ci,
                   ci, ci, vp]
    fn.restype = ci
    built = Built(lib=lib, key=key, seconds=seconds, log=log)
    _LOADED[key] = built
    return built
