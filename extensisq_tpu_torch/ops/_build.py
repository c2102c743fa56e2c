"""Build and load the port's CUDA kernels.

Each kernel ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C entry point ``<name>_launch`` and loaded
with ``ctypes``.  A kernel is specialised per (method, right-hand side,
mass matrix), or for the RKC kernels per (grid shape, parameter count,
right-hand side, rho callback): a generated header,
``<name>_config.cuh``, holds the method's data rounded to float32 exactly
as the JAX kernel rounds it, as ``constexpr`` data, and the user's CUDA
RHS.  The build key hashes the
kernel source, every ``csrc/*.cuh`` it includes (directly or through
another shared header), the generated header and the flags; the library
lands in ``extensisq_tpu_torch/_build/<name>_<key>/`` at first use and is
reused after.  Nothing is built when this module is imported.
"""
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
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


def fused_erk_header(k, n, rhs_src, npar=0, record=False, snap=False):
    """Text of ``fused_erk_config.cuh`` for the constants ``k`` of
    ``ops.fused_erk._fused_consts``, state size ``n``, the CUDA RHS
    source, its number of per-member parameters ``npar`` and whether the
    build writes the dense record (``record``, ``tab::REC``) and the
    t_eval snapshots (``snap``, ``tab::SNAP``)."""
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
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
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


def _accessor(name, values, ret="float"):
    """A ``constexpr`` accessor ``name(i)`` or ``name(i, j)`` returning the
    float32 literals of ``values`` (zeros by default).  Unlike an array, a
    function can be called with loop indices in device code; after
    unrolling every call folds to its literal."""
    values = np.asarray(values)
    if values.ndim == 1:
        args, idx = "int i", [(f"i == {i}", v) for i, v in enumerate(values)]
    else:
        args = "int i, int j"
        idx = [(f"i == {i} && j == {j}", values[i, j])
               for i in range(values.shape[0])
               for j in range(values.shape[1])]
    if ret == "bool":
        conds = [c for c, v in idx if v]
        body = " || ".join(f"({c})" for c in conds) or "false"
    else:
        body = "".join(f"{c} ? {_f32(v)} : "
                       for c, v in idx if np.float32(v) != 0.0) + "0.0f"
    return (f"__host__ __device__ constexpr {ret} {name}({args}) {{\n"
            f"  return {body};\n}}")


def _rk_constants(k):
    """The controller and starting-step constants of the fused explicit
    kernels' generated headers, from the constants ``k`` of
    ``ops.fused_erk._fused_consts`` or ``ops.fused_rkn.rkn_consts``."""
    cc, hs = k["cc"], k["hstart"]
    return "\n".join(
        f"constexpr float {name} = {_f32(value)};" for name, value in (
            ("SAFETY", cc.safety), ("SAFETY_SC", cc.safety_sc),
            ("MINBETA1", cc.minbeta1), ("MINBETA2", cc.minbeta2),
            ("MINALPHA", cc.minalpha), ("ERROR_EXPONENT", cc.error_exponent),
            ("MIN_FACTOR", cc.min_factor), ("H_MIN_A", k["h_min_a"]),
            ("TINY_ERR", k["tiny_err"]), ("HS_BIG", hs["big"]),
            ("HS_SMALL", hs["small"]), ("HS_RELPER", hs["relper"]),
            ("HS_T_FLOOR", hs["t_floor"])))


def _rk_accessors(k):
    """``constexpr`` accessors of an explicit tableau: A, AP, B, BP, C, E,
    EP (the velocity weights are zero for a first-order ERK tableau)."""
    A = k["A"]
    zeros = np.zeros(A.shape[0])
    return "\n".join([
        _accessor("A", A), _accessor("AP", k.get("Ap", np.zeros_like(A))),
        _accessor("B", k["B"]), _accessor("BP", k.get("Bp", zeros)),
        _accessor("C", k["C"]), _accessor("E", k["E"]),
        _accessor("EP", k.get("Ep", np.zeros(A.shape[0] + 1)))])


def _ck_accessors(k):
    """``constexpr`` accessors of CKdisc's cascade: the assessment rows
    BAS(r, j)/EAS(r, j) (E1 after two stages, E2 after four), the fallback
    rows BFB(r, j)/EFB(r, j) and their nodes CFB(r) (r = 0: the 2nd-order
    solution at c = 1/5, r = 1: the 3rd-order one at 3/5); zeros for the
    other families."""
    rows = [_accessor(name, k.get(key, np.zeros((2, 1)))) for name, key in (
        ("BAS", "B_as"), ("EAS", "E_as"), ("BFB", "B_fb"), ("EFB", "E_fb"))]
    return "\n".join(rows + [_accessor("CFB", k.get("C_fb", np.zeros(2)))])


def _flag(b):
    return "true" if b else "false"


def fused_rkn_header(k, m, acc_src, npar=0, record=False, snap=False):
    """Text of ``fused_rkn_config.cuh`` for the constants ``k`` of
    ``ops.fused_rkn.rkn_consts``, ``m`` positions, the CUDA source of the
    acceleration ``acc``, its number of per-member parameters ``npar`` and
    whether the build writes the dense record (``record``, ``tab::REC``)
    and the t_eval snapshots (``snap``, ``tab::SNAP``)."""
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// RKN tableau {k['name']} rounded to float32, and the user's acceleration.
#pragma once

namespace tab {{
constexpr int M = {int(m)};
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
constexpr int S = {k['s']};
constexpr bool FSAL = {_flag(k['fsal'])};
constexpr int MORDER = {k['morder']};
{_rk_accessors(k)}
{_rk_constants(k)}
}}  // namespace tab

{acc_src}
"""


GRID_RHS_STUB = ("__device__ float rhs(float t, const float* y, int i, "
                 "const float* p) { return 0.0f; }")
GRID_ACC_STUB = ("__device__ float acc(float t, const float* u, "
                 "const float* v, int i, const float* p) { return 0.0f; }")


def fused_rk_grid_header(k, rkn, shape, src, npar=0, record=False,
                         snap=False):
    """Text of ``fused_rk_grid_config.cuh`` for the constants ``k`` of an
    ERK (``rkn`` False) or RKN method, or of CKdisc's cascade
    (``ops.fused_ckdisc.ck_consts``), a member grid of extents ``shape``
    (one stage row: the states of an ERK system, the positions of an RKN
    one), the CUDA source of the right-hand side ``rhs`` or the
    acceleration ``acc`` (the other of the two is a stub never called),
    its number of per-member parameters ``npar`` (``params`` of B4, B6
    and B12) and whether the build writes the dense record (``record``,
    ``tab::REC``; B4 and B6) and the t_eval snapshots (``snap``,
    ``tab::SNAP``; B4, B6 and B12)."""
    dims = ", ".join(str(int(d)) for d in shape)
    ck = "B_as" in k
    family = "RKN" if rkn else ("CKdisc" if ck else "ERK")
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// {family} tableau {k['name']} rounded to float32, the
// member grid and the user's {'acceleration' if rkn else 'right-hand side'}.
#pragma once

namespace tab {{
using G = grid::Grid<{dims}>;
constexpr int N = {int(np.prod(shape))};
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
constexpr bool RKN = {_flag(rkn)};
constexpr bool CK = {_flag(ck)};
constexpr int S = {k['s']};
constexpr bool FSAL = {_flag(k['fsal'])};
constexpr int MORDER = {k['morder']};
{_rk_accessors(k)}
{_ck_accessors(k)}
{_rk_constants(k)}
}}  // namespace tab

{src}

{GRID_RHS_STUB if rkn else GRID_ACC_STUB}
"""


def fused_ckdisc_header(k, n, rhs_src, npar=0, snap=False):
    """Text of ``fused_ckdisc_config.cuh`` for the constants ``k`` of
    ``ops.fused_ckdisc.ck_consts``, state size ``n``, the CUDA RHS source,
    its number of per-member parameters ``npar`` and whether the build
    writes the t_eval snapshots (``snap``, ``tab::SNAP``)."""
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// CKdisc's tableau and cascade weights rounded to float32, and the user's
// right-hand side.
#pragma once

namespace tab {{
constexpr int N = {int(n)};
constexpr int NPAR = {int(npar)};
constexpr bool SNAP = {_flag(snap)};
constexpr int S = {k['s']};
constexpr int MORDER = {k['morder']};
{_rk_accessors(k)}
{_ck_accessors(k)}
{_rk_constants(k)}
}}  // namespace tab

{rhs_src}
"""


def _esdirk_constants(k):
    """The method and controller constants of the fused ESDIRK kernels'
    generated headers, from the constants ``k`` of
    ``ops.fused_esdirk._esdirk_consts``, and the tableau accessors A, AZ,
    C and E."""
    from .._config import (NEWTON_MAXITER, MAX_RATE, MAX_FACTOR_NRF,
                           MAX_FACTOR, MAX_FACTOR0)
    cc, hs = k["cc"], k["hstart"]
    return f"""constexpr int S = {k['s']};
constexpr int MORDER = {k['morder']};
constexpr int NEWTON_MAXITER = {NEWTON_MAXITER};
constexpr bool FILTER_ERROR = {_flag(k['filter_error'])};
constexpr float D = {_f32(k['d'])};
constexpr float INV_D = {_f32(k['inv_d'])};
constexpr float KAPPA = {_f32(k['kappa'])};
constexpr float SAFETY = {_f32(cc.safety)};
constexpr float SAFETY_SC = {_f32(cc.safety_sc)};
constexpr float MINBETA1 = {_f32(cc.minbeta1)};
constexpr float MINBETA2 = {_f32(cc.minbeta2)};
constexpr float MINALPHA = {_f32(cc.minalpha)};
constexpr float ERROR_EXPONENT = {_f32(cc.error_exponent)};
constexpr float MIN_FACTOR = {_f32(cc.min_factor)};
constexpr float MAX_FACTOR = {_f32(MAX_FACTOR)};
constexpr float MAX_FACTOR0 = {_f32(MAX_FACTOR0)};
constexpr float MAX_RATE = {_f32(MAX_RATE)};
constexpr float MAX_FACTOR_NRF = {_f32(MAX_FACTOR_NRF)};
constexpr float H_MIN_A = {_f32(k['h_min_a'])};
constexpr float H_MIN_B = {_f32(k['h_min_b'])};
constexpr float LAND_TOL = {_f32(k['land_tol'])};
constexpr float HS_BIG = {_f32(hs['big'])};
constexpr float HS_SMALL = {_f32(hs['small'])};
constexpr float HS_RELPER = {_f32(hs['relper'])};
constexpr float HS_T_FLOOR = {_f32(hs['t_floor'])};
""" + "\n".join([_accessor("A", k["A"]), _accessor("AZ", k["Az"]),
                 _accessor("C", k["C"]), _accessor("E", k["E"])])


def fused_esdirk_header(k, m_diag, rot, n, rhs_src, npar=0, nb=None,
                        record=False, snap=False):
    """Text of ``fused_esdirk_config.cuh`` for the constants ``k`` of
    ``ops.fused_esdirk._esdirk_consts``, the mass-matrix setup ``(m_diag,
    rot)`` of ``ops.fused_esdirk._mass_setup``, state size ``n``, the
    CUDA RHS source (the template form ``rhs<T>``), its number of
    per-member parameters ``npar``, the simultaneous corrector's base
    block ``nb`` (None: the whole state) and whether the build writes the
    dense record (``record``, ``tab::REC``) and the t_eval snapshots
    (``snap``, ``tab::SNAP``)."""
    mass = np.ones(n) if m_diag is None else np.asarray(m_diag, float)
    inv_mass = np.array([1.0 / m if m else 0.0 for m in mass])
    if rot is None:
        vh = v = uts = np.eye(n)
    else:
        vh, uts = rot
        v = vh.T
    accessors = "\n".join([
        _accessor("MASS", mass), _accessor("INV_MASS", inv_mass),
        _accessor("ALG", mass == 0.0, "bool"),
        _accessor("VH", vh), _accessor("V", v), _accessor("UTS", uts)])
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// ESDIRK method {k['name']} rounded to float32, the mass-matrix setup and
// the user's right-hand side.
#pragma once

namespace tab {{
constexpr int N = {n};
constexpr int NB = {n if nb is None else int(nb)};
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
constexpr bool HAS_M = {_flag(m_diag is not None)};
constexpr bool ROT = {_flag(rot is not None)};
{_esdirk_constants(k)}
{accessors}
}}  // namespace tab

{rhs_src}
"""


def fused_esdirk_grid_header(k, shape, rhs_src, npar=0, nb=None,
                             record=False, snap=False):
    """Text of ``fused_esdirk_grid_config.cuh`` for the constants ``k`` of
    ``ops.fused_esdirk._esdirk_consts``, a member grid of extents ``shape``,
    the CUDA source of the template right-hand side ``rhs<T>(T t, const T*
    y, int i, const T* p)``, its number of per-member parameters ``npar``,
    the simultaneous corrector's base block ``nb`` (None: the whole state)
    and whether the build writes the dense record (``record``,
    ``tab::REC``) and the t_eval snapshots (``snap``, ``tab::SNAP``);
    ``L`` is the number of cyclic reduction rounds, ceil(log2 nb) over the
    base block's rows."""
    n = int(np.prod(shape))
    nb = n if nb is None else int(nb)
    dims = ", ".join(str(int(d)) for d in shape)
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// ESDIRK method {k['name']} rounded to float32, the member grid and the
// user's right-hand side.
#pragma once

namespace tab {{
using G = grid::Grid<{dims}>;
constexpr int N = {n};
constexpr int NB = {nb};
constexpr int L = {(nb - 1).bit_length()};
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
{_esdirk_constants(k)}
}}  // namespace tab

{rhs_src}
"""


def fused_adams_header(k, rhs_src, shape=None, npar=0, record=False,
                       snap=False):
    """Text of ``fused_adams_config.cuh`` (or, for a member grid of extents
    ``shape``, of the mid-size kernel's ``fused_adams_grid_config.cuh``)
    for the constants ``k`` of ``ops.fused_adams._adams_consts`` (order
    bound ``KM``, state size ``N``, the Adams error constants ``gstr``,
    ``iqq`` and the ``2^(q+1)`` doubling table, rounded to float32 as the
    JAX kernel rounds them), the CUDA RHS source (``rhs(float t, ...)``
    or the template ``rhs<T>``), its number of per-member parameters
    ``npar`` and whether the build writes the dense record (``record``,
    ``tab::REC``) and the t_eval snapshots (``snap``, ``tab::SNAP``)."""
    accessors = "\n".join([_accessor("GSTR", k["gstr"]),
                           _accessor("IQQ", k["iqq"]),
                           _accessor("TWO", k["two"])])
    grid = ("" if shape is None else "using G = grid::Grid<"
            + ", ".join(str(int(d)) for d in shape) + ">;\n")
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// SWAG with k_max = {k['km']} for N = {k['n']}, its constants rounded to
// float32, and the user's right-hand side.
#pragma once

namespace tab {{
{grid}constexpr int KM = {k['km']};
constexpr int N = {k['n']};
constexpr int NPAR = {int(npar)};
constexpr bool REC = {_flag(record)};
constexpr bool SNAP = {_flag(snap)};
constexpr float INV_N = {_f32(k['inv_n'])};
constexpr float FOURU_T = {_f32(k['fouru_t'])};
constexpr float LAND_TOL = {_f32(k['land_tol'])};
{accessors}
}}  // namespace tab

{rhs_src}
"""


def fused_rkc_header(shape, n_par, rhs_src, rho_src=None, snap=False):
    """Text of ``fused_rkc_config.cuh`` for a member grid of extents
    ``shape``, ``n_par`` per-member parameters, the CUDA right-hand side
    ``rhs(float t, const float* y, int i, const float* p)``, where given
    the spectral-radius callback ``rho(float t, const float* y, const
    float* p)`` (a stub that is never called otherwise) and whether the
    build writes the t_eval snapshots (``snap``, ``tab::SNAP``)."""
    from .fused_rkc import _rkc_consts
    k = _rkc_consts()
    ntot = int(np.prod(shape))
    dims = ", ".join(str(int(d)) for d in shape)
    if rho_src is None:
        rho_src = ("__device__ float rho(float t, const float* y, "
                   "const float* p) { return 0.0f; }")
    return f"""// Generated by extensisq_tpu_torch/ops/_build.py; do not edit.
// The fused RKC kernel's grid, float32 constants and the user's functions.
#pragma once

namespace tab {{
using G = grid::Grid<{dims}>;
constexpr int NTOT = {ntot};
constexpr int NPAR = {int(n_par)};
constexpr bool SNAP = {_flag(snap)};
constexpr float SQRTMIN = {_f32(k['sqrtmin'])};
constexpr float SQRTU = {_f32(k['sqrtu'])};
constexpr float ONE_P_SQRTU = {_f32(k['one_p_sqrtu'])};
constexpr float RHO_UROUND = {_f32(k['rho_uround'])};
constexpr float HMIN_C = {_f32(k['hmin_c'])};
}}  // namespace tab

{rhs_src}

{rho_src}
"""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _compile(name, header, out_dir):
    """nvcc ``csrc/<name>.cu`` (with its generated ``header`` in out_dir)
    into out_dir/lib.so; returns (seconds, compiler output)."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}_config.cuh").write_text(header)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-I", str(CSRC), "-o",
           tmp, str(CSRC / f"{name}.cu")]
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _included(texts, found=()):
    """The ``csrc/*.cuh`` files that ``texts`` include, directly or through
    another of them, in include order, past those already ``found``."""
    found = list(found)
    new = []
    todo = list(texts)
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0)):
            path = CSRC / inc
            if path.exists() and path not in found:
                found.append(path)
                new.append(path)
                todo.append(path.read_text())
    return new


def shared_headers(name):
    """The ``csrc/*.cuh`` files that ``csrc/<name>.cu`` includes, directly
    or through another of them, in include order (the generated config
    header lives in the build directory and is not among them)."""
    return _included([(CSRC / f"{name}.cu").read_text()])


def build_key(name, header):
    """Hash of everything the build of ``name`` reads: its source, the
    shared headers it includes, the generated header, the shared headers
    that one includes (a variational system's source includes dual.cuh)
    and the flags."""
    parts = [(CSRC / f"{name}.cu").read_text()]
    shared = shared_headers(name)
    shared += _included([header], shared)
    parts += [f"{p.name}\0{p.read_text()}" for p in shared]
    parts += [header, " ".join(NVCC_FLAGS)]
    return hashlib.sha256("\0".join(parts).encode()).hexdigest()[:16]


def load_kernel(name, header, argtypes):
    """Build (at first use) and load ``csrc/<name>.cu`` with its generated
    ``header``; returns :class:`Built` with ``lib.<name>_launch`` bound to
    ``argtypes`` (returning the CUDA error code as an int)."""
    key = build_key(name, header)
    if key in _LOADED:
        return _LOADED[key]
    out_dir = BUILD_DIR / f"{name}_{key}"
    so = out_dir / "lib.so"
    seconds, log = 0.0, ""
    if so.exists():
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _compile(name, header, out_dir)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    built = Built(lib=lib, key=key, seconds=seconds, log=log)
    _LOADED[key] = built
    return built


# (wrapper, ids of its objects, extra key) -> (objects, built kernel)
_CACHE = {}


def cached(kind, objects, build, extra=()):
    """The kernel ``build()`` returns for the wrapper ``kind`` and its
    ``objects`` (method, right-hand side, callbacks; ``None`` allowed)
    with the hashable ``extra``: built at first use, then looked up by the
    objects' ids without touching the source or the disk.  The entry holds
    the objects, so their ids are not reused while it lives."""
    key = (kind, tuple(id(o) for o in objects), extra)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = (tuple(objects), build())
    return hit[1]


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# the record arguments of the dense-output launches, before the stream:
# rec_t, rec_y, rec_f, rec_f0, rec_n and the rows a member
_REC_ARGS = [_VP, _VP, _VP, _VP, _VP, _CI]


def _bind_record(built, name, argtypes):
    """Bind ``lib.<name>_record_launch``: ``argtypes`` of the launch with
    the record arguments before the stream."""
    fn = getattr(built.lib, f"{name}_record_launch")
    fn.argtypes = argtypes[:-1] + _REC_ARGS + argtypes[-1:]
    fn.restype = ctypes.c_int
    return built


# the snapshot arguments of the t_eval launches, before the stream: the
# sorted points, their indices in t_eval, y_eval and the number of points
_SNAP_ARGS = [_VP, _VP, _VP, _CI]


def _bind_snap(built, name, argtypes, record=True):
    """Bind ``lib.<name>_snap_launch``: ``argtypes`` of the launch with the
    record arguments (where the kernel takes them, ``record``) and the
    snapshot arguments before the stream."""
    fn = getattr(built.lib, f"{name}_snap_launch")
    fn.argtypes = (argtypes[:-1] + (_REC_ARGS if record else [])
                   + _SNAP_ARGS + argtypes[-1:])
    fn.restype = ctypes.c_int
    return built


def load_fused_erk(consts, n, rhs_src, npar=0, record=False, snap=False):
    """Build (at first use) and load the fused ERK kernel for one tableau,
    RHS, parameter count, dense-record switch and snapshot switch; returns
    :class:`Built` with ``lib.fused_erk_launch``,
    ``lib.fused_erk_record_launch`` and ``lib.fused_erk_snap_launch``
    bound (each refuses a build of another kind)."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF, _CF, _CF,
                _CI, _CF, _CI, _CI, _CI, _CI, _VP]
    built = _bind_record(load_kernel(
        "fused_erk",
        fused_erk_header(consts, n, rhs_src, npar, record, snap), argtypes),
        "fused_erk", argtypes)
    return _bind_snap(built, "fused_erk", argtypes)


def load_fused_rkn(consts, m, acc_src, npar=0, record=False, snap=False):
    """Build (at first use) and load the fused RKN kernel (B5) for one
    tableau, acceleration, parameter count, dense-record switch and
    snapshot switch; returns :class:`Built` with ``lib.fused_rkn_launch``,
    ``lib.fused_rkn_record_launch`` and ``lib.fused_rkn_snap_launch``
    bound (each refuses a build of another kind)."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF, _CF, _CF,
                _CI, _CF, _CI, _CI, _CI, _CI, _VP]
    return _bind_snap(_bind_record(load_kernel(
        "fused_rkn", fused_rkn_header(consts, m, acc_src, npar, record, snap),
        argtypes), "fused_rkn", argtypes), "fused_rkn", argtypes)


def load_fused_rk_grid(consts, rkn, shape, src, npar=0, record=False,
                       snap=False):
    """Build (at first use) and load the block-per-member kernel (B4 for
    an ERK tableau, B6 for an RKN one, B12 for CKdisc's cascade) for one
    member grid, right-hand side, parameter count, dense-record switch (B4
    and B6) and snapshot switch; returns :class:`Built` with
    ``lib.fused_rk_grid_launch``, ``lib.fused_rk_grid_record_launch``,
    ``lib.fused_rk_grid_snap_launch`` and ``lib.fused_rk_grid_smem``
    bound."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF, _CF, _CF,
                _CF, _CI, _CF, _CI, _CI, _CI, _CI, _VP]
    built = _bind_snap(_bind_record(load_kernel(
        "fused_rk_grid",
        fused_rk_grid_header(consts, rkn, shape, src, npar, record, snap),
        argtypes), "fused_rk_grid", argtypes), "fused_rk_grid", argtypes)
    smem = built.lib.fused_rk_grid_smem
    smem.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    smem.restype = ctypes.c_int
    return built


def load_fused_ckdisc(consts, n, rhs_src, npar=0, snap=False):
    """Build (at first use) and load the fused CKdisc kernel (B11) for one
    RHS, parameter count and snapshot switch; returns :class:`Built` with
    ``lib.fused_ckdisc_launch`` and ``lib.fused_ckdisc_snap_launch`` bound
    (each refuses a build of the other kind)."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF, _CF, _CF,
                _CI, _CF, _CI, _CI, _CI, _VP]
    return _bind_snap(load_kernel(
        "fused_ckdisc", fused_ckdisc_header(consts, n, rhs_src, npar, snap),
        argtypes), "fused_ckdisc", argtypes, record=False)


def load_fused_esdirk(consts, m_diag, rot, n, rhs_src, npar=0, nb=None,
                      record=False, snap=False):
    """Build (at first use) and load the fused ESDIRK kernel for one
    method, mass-matrix setup, RHS, parameter count, base block (None: no
    simultaneous corrector), dense-record switch and snapshot switch, with
    each lane count per member the launch takes; returns :class:`Built`
    with ``lib.fused_esdirk_launch``, ``lib.fused_esdirk_record_launch``
    and ``lib.fused_esdirk_snap_launch`` bound (each refuses a build of
    another kind)."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF, _CF,
                _CF, _CI, _CI, _CF, _CI, _CF, _CI, _CI, _CI, _VP]
    return _bind_snap(_bind_record(load_kernel(
        "fused_esdirk",
        fused_esdirk_header(consts, m_diag, rot, n, rhs_src, npar, nb,
                            record, snap), argtypes), "fused_esdirk",
        argtypes), "fused_esdirk", argtypes)


def load_fused_esdirk_grid(consts, shape, rhs_src, npar=0, nb=None,
                           record=False, snap=False):
    """Build (at first use) and load the mid-size ESDIRK kernel (B7) for
    one method, member grid, RHS, parameter count, base block (None: no
    simultaneous corrector), dense-record switch and snapshot switch;
    returns :class:`Built` with ``lib.fused_esdirk_grid_launch``,
    ``lib.fused_esdirk_grid_record_launch``,
    ``lib.fused_esdirk_grid_snap_launch`` and
    ``lib.fused_esdirk_grid_smem`` bound."""
    argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CF, _CF, _CF,
                _CF, _CF, _CI, _CI, _CF, _CI, _CF, _CI, _CI, _CI, _VP]
    built = _bind_snap(_bind_record(load_kernel(
        "fused_esdirk_grid",
        fused_esdirk_grid_header(consts, shape, rhs_src, npar, nb, record,
                                 snap),
        argtypes), "fused_esdirk_grid", argtypes), "fused_esdirk_grid",
        argtypes)
    smem = built.lib.fused_esdirk_grid_smem
    smem.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    smem.restype = ctypes.c_int
    return built


def load_fused_adams(consts, rhs_src, npar=0, record=False, snap=False):
    """Build (at first use) and load the fused SWAG kernel for one
    ``k_max``, state size, RHS, parameter count, dense-record switch and
    snapshot switch, with each lane count per member the wrapper takes;
    returns :class:`Built` with ``lib.fused_adams_launch``,
    ``lib.fused_adams_record_launch`` and ``lib.fused_adams_snap_launch``
    bound (each refuses a build of another kind)."""
    argtypes = [_VP] * 10 + [_CI, _CF, _CF, _CF, _CF, _CF, _CF, _CI, _CI,
                             _CI, _CI, _VP]
    return _bind_snap(_bind_record(load_kernel(
        "fused_adams",
        fused_adams_header(consts, rhs_src, None, npar, record, snap),
        argtypes), "fused_adams", argtypes), "fused_adams", argtypes)


def load_fused_adams_grid(consts, shape, rhs_src, npar=0, record=False,
                          snap=False):
    """Build (at first use) and load the mid-size SWAG kernel (B8) for one
    ``k_max``, member grid, RHS, parameter count, dense-record switch and
    snapshot switch; returns :class:`Built` with
    ``lib.fused_adams_grid_launch``, ``lib.fused_adams_grid_record_launch``,
    ``lib.fused_adams_grid_snap_launch`` and ``lib.fused_adams_grid_smem``
    bound."""
    argtypes = [_VP] * 9 + [_CI, _CF, _CF, _CF, _CF, _CF, _CF, _CI, _CI, _VP]
    built = _bind_snap(_bind_record(load_kernel(
        "fused_adams_grid",
        fused_adams_header(consts, rhs_src, shape, npar, record, snap),
        argtypes), "fused_adams_grid", argtypes), "fused_adams_grid",
        argtypes)
    smem = built.lib.fused_adams_grid_smem
    smem.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    smem.restype = ctypes.c_int
    return built


def load_fused_rkc(shape, n_par, rhs_src, rho_src=None, snap=False):
    """Build (at first use) and load the fused RKC kernels (B9 and B10) for
    one grid shape, parameter count, right-hand side and snapshot switch;
    returns :class:`Built` with ``lib.fused_rkc_launch``,
    ``lib.fused_rkc_snap_launch`` (each refuses a build of the other kind),
    ``lib.fused_rkc_grid_capacity``, ``lib.fused_rkc_grid_smem`` and
    ``lib.fused_rkc_cluster_capacity`` bound."""
    argtypes = [_CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI,
                _CF, _CF, _CF, _CF, _CF, _CF, _CF, _CF, _CI, _CI, _CI, _CI,
                _CI, _CI, _VP]
    built = load_kernel(
        "fused_rkc", fused_rkc_header(shape, n_par, rhs_src, rho_src, snap),
        argtypes)
    # the snapshot launch takes the points in t_eval's order, y_eval and
    # their count before the stream
    snap_launch = built.lib.fused_rkc_snap_launch
    snap_launch.argtypes = argtypes[:-1] + [_VP, _VP, _CI, _VP]
    snap_launch.restype = ctypes.c_int
    cap = built.lib.fused_rkc_grid_capacity
    cap.argtypes = [_CI, _CI, ctypes.POINTER(ctypes.c_int)]
    cap.restype = ctypes.c_int
    smem = built.lib.fused_rkc_grid_smem
    smem.argtypes = [_CI, _CI, _CI] + [ctypes.POINTER(ctypes.c_int)] * 2
    smem.restype = ctypes.c_int
    ccap = built.lib.fused_rkc_cluster_capacity
    ccap.argtypes = [_CI, _CI, _CI] + [ctypes.POINTER(ctypes.c_int)] * 2
    ccap.restype = ctypes.c_int
    return built
