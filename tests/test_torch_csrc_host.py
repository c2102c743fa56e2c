"""The CUDA kernels' sources, compiled for the host and held against their
plain PyTorch versions on the CPU.

``nvcc`` and the card exist only on the machine with the GPU, but the
kernels are plain C++ apart from a few CUDA keywords and intrinsics.  A
small shim header defines those for the host (``__device__`` and friends
away; ``__fadd_rn``/``__fsub_rn``/``__fmul_rn`` as operations the compiler
cannot contract; ``blockIdx``/``threadIdx`` as variables), and the
``extern "C"`` launch is replaced by a loop over the members.  g++ then
builds each kernel with the generated header the wrapper would use, with
``-ffp-contract=off``: no product is fused into an fma, as in PyTorch's
CPU operations.  So the kernel's logic, not only its plain version, is
checked on every CPU run: its first attempts are bit-identical to the
plain version's, and what remains is the libraries' ``powf``/``log10f``
and the dual numbers' derivative round-off.  The SWAG kernel starts from
the float32 stepper's ``init``, as its wrapper starts it.  Skipped where
no g++ is installed.
"""
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fused_adams as TA  # noqa: E402
import test_torch_fused_esdirk as T  # noqa: E402
import test_torch_fused_erk as TK  # noqa: E402

from extensisq_tpu_torch.ops import _build  # noqa: E402
from extensisq_tpu_torch.ops import fused_adams as FA  # noqa: E402
from extensisq_tpu_torch.ops import fused_erk as FK  # noqa: E402
from extensisq_tpu_torch.ops import fused_esdirk as FE  # noqa: E402

SHIM = """
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
struct HostDim3 { int x; };
static HostDim3 blockIdx, blockDim, threadIdx;
__attribute__((noinline)) static float __fadd_rn(float a, float b) {
  volatile float r = a + b; return r; }
__attribute__((noinline)) static float __fsub_rn(float a, float b) {
  volatile float r = a - b; return r; }
__attribute__((noinline)) static float __fmul_rn(float a, float b) {
  volatile float r = a * b; return r; }
using std::isfinite;
using std::max;
using std::min;
"""

ESDIRK_LAUNCH = """
extern "C" int fused_esdirk_launch(
    const void* y0, const void* yp0, void* y_out, void* status, void* nstep,
    void* nfev, int B, float t0, float tf, float rtol, float atol, float h0,
    int use_hstart, int have_yp0, float max_step, int max_steps,
    float tiny_err, int compensated, int threads, void* stream) {
  blockDim.x = 1;
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    threadIdx.x = 0;
    auto k = compensated ? fused_esdirk_kernel<true>
                         : fused_esdirk_kernel<false>;
    k((const float*)y0, (const float*)yp0, (float*)y_out, (int*)status,
      (int*)nstep, (int*)nfev, B, t0, tf, rtol, atol, h0, use_hstart,
      have_yp0, max_step, max_steps, tiny_err);
  }
  return 0;
}
"""

ERK_LAUNCH = """
extern "C" int fused_erk_launch(
    const void* y0, void* y_out, void* status, void* nstep, void* nfev,
    int B, float t0, float tf, float rtol, float atol, float h0,
    int use_hstart, float max_step, int max_steps, int compensated,
    int threads, void* stream) {
  blockDim.x = 1;
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    threadIdx.x = 0;
    auto k = compensated ? fused_erk_kernel<true> : fused_erk_kernel<false>;
    k((const float*)y0, (float*)y_out, (int*)status, (int*)nstep,
      (int*)nfev, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
      max_steps);
  }
  return 0;
}
"""

ADAMS_LAUNCH = """
extern "C" int fused_adams_launch(
    const void* y0, const void* yp0, const void* h0, const void* nfev0,
    void* y_out, void* status, void* nstep, void* nfev, int B, float t0,
    float tf, float dir, float rtol, float atol, float max_step,
    int max_steps, int compensated, int threads, void* stream) {
  blockDim.x = 1;
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    threadIdx.x = 0;
    auto k = compensated ? fused_adams_kernel<true>
                         : fused_adams_kernel<false>;
    k((const float*)y0, (const float*)yp0, (const float*)h0,
      (const int*)nfev0, (float*)y_out, (int*)status, (int*)nstep,
      (int*)nfev, B, t0, tf, dir, rtol, atol, max_step, max_steps);
  }
  return 0;
}
"""

# label -> (problem, k_max) of each SWAG build; the cases of
# test_torch_fused_adams.py, and the bench line's k_max = 12
ADAMS_VARIANTS = {"vdp": ("vdp5", 6), "osc_comp": ("osc", 4),
                  "decay_1e6": ("decay", 6), "bench": ("vdp1e3", 4),
                  "bench12": ("vdp1e3", 12)}
ADAMS_CASES = dict(TA.CASES, bench12=(
    "vdp1e3", (0.0, 0.05), TA.X0,
    dict(rtol=1e-6, atol=1e-9, k_max=12, compensated=True)))

ESDIRK_VARIANTS = {           # label -> (problem, method, M)
    "rob_kv3i": ("rob", "Kv3I", None),
    "rob_trbdf2": ("rob", "TRBDF2", None),
    "pend": ("pend", "Kv3I", T.M_PEND),
    "kaps_hidden": ("kaps_hidden", "TRBDF2", T.M_HIDDEN),
}
VARIANT_OF = {"rob_kv3i": "rob_kv3i", "rob_kv3i_comp": "rob_kv3i",
              "rob_trbdf2": "rob_trbdf2", "pend_dae": "pend",
              "kaps_hidden": "kaps_hidden"}
VDP_TEMPLATE = FK.FusedRHS(
    TK.PROBLEMS["vdp"].torch_fn,
    "template <class T>\n__device__ void rhs(T t, const T* y, T* dy) {\n"
    "  dy[0] = y[1];\n"
    "  dy[1] = 3.0f * (1.0f - y[0] * y[0]) * y[1] - y[0];\n}", 2)


def _compile(name, header, launch, out_dir):
    src = (_build.CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src[:src.index('extern "C"')] + launch
    out_dir.mkdir(parents=True)
    (out_dir / "shim.h").write_text(SHIM)
    (out_dir / f"{name}_config.cuh").write_text(header)
    (out_dir / "kernel.cpp").write_text(src)
    so = out_dir / "lib.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-Wno-unknown-pragmas", "-include",
                    str(out_dir / "shim.h"), "-I", str(out_dir), "-I",
                    str(_build.CSRC), "-o", str(so),
                    str(out_dir / "kernel.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every kernel variant built for the host, in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    jobs = {}
    for label, (prob, meth, M) in ESDIRK_VARIANTS.items():
        rhs = T.PROBLEMS[prob]
        header = _build.fused_esdirk_header(
            FE._esdirk_consts(T.METHODS[meth]), *FE._mass_setup(M, rhs.n),
            rhs.n, rhs.cuda_src)
        jobs[label] = ("fused_esdirk", header, ESDIRK_LAUNCH)
    for label, rhs in (("vdp", TK.PROBLEMS["vdp"]),
                       ("vdp_template", VDP_TEMPLATE)):
        header = _build.fused_erk_header(FK._fused_consts(TK.BS5), rhs.n,
                                         rhs.cuda_src)
        jobs[label] = ("fused_erk", header, ERK_LAUNCH)
    for label, (prob, km) in ADAMS_VARIANTS.items():
        rhs = TA.PROBLEMS[prob]
        jobs["adams_" + label] = (
            "fused_adams",
            _build.fused_adams_header(FA._adams_consts(km, rhs.n),
                                      rhs.cuda_src), ADAMS_LAUNCH)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_compile, *v, d / k)
                   for k, v in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _esdirk_host(lib, case, **over):
    prob, meth, span, y0, yp0, M, kw = T.CASES[case]
    kw = dict(kw, **over)
    rtol, atol = kw.pop("rtol"), kw.pop("atol")
    comp = kw.pop("compensated", False)
    max_steps = kw.pop("max_steps", 100_000)
    assert not kw
    y0 = np.ascontiguousarray(y0, np.float32)
    nb, n = y0.shape
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    t0, tf = np.float32(span[0]), np.float32(span[1])
    yp = None if yp0 is None else np.ascontiguousarray(yp0, np.float32)
    fn = lib.fused_esdirk_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 6 + [ci, cf, cf, cf, cf, cf, ci, ci, cf, ci, cf,
                              ci, ci, vp]
    fn(y0.ctypes.data, None if yp is None else yp.ctypes.data,
       out.ctypes.data, st.ctypes.data, ns.ctypes.data, nf.ctypes.data, nb,
       float(t0), float(tf), rtol, atol,
       float(np.float32(0.01) * abs(tf - t0)), int(M is None),
       int(yp is not None), np.inf, max_steps, FE._tiny_err(n, rtol),
       int(comp), 128, None)
    return out, st, ns, nf


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# rob_kv3i 3.6e-7, 1, 6; rob_kv3i_comp 3.7e-9, 1, 13; rob_trbdf2 1.7e-6,
# 1, 2; pend_dae 4.8e-6, 1, 11; kaps_hidden 6.7e-7, 0, 4.  Gates about 2x.
GATES = [("rob_kv3i", 1e-6, 2, 12), ("rob_kv3i_comp", 1e-8, 2, 26),
         ("rob_trbdf2", 4e-6, 2, 4), ("pend_dae", 1e-5, 2, 22),
         ("kaps_hidden", 2e-6, 1, 8)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers", GATES)
def test_esdirk_kernel_matches_plain_version(libs, case, y_gate, dsteps,
                                             nmembers):
    y, st, ns, nf = _esdirk_host(libs[VARIANT_OF[case]], case)
    ry, rst, rns, rnf = T._port(case)
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [("pend_dae", 1),
                                           ("kaps_hidden", 3)])
def test_esdirk_kernel_first_attempts_bit_identical(libs, case, attempts):
    """Without a starting-step estimate, the kernel's first attempts (the
    dual-number Jacobian, the factor, Newton, the error and the controller
    up to its powf) repeat the plain version's arithmetic bit for bit."""
    y, st, ns, nf = _esdirk_host(libs[VARIANT_OF[case]], case,
                                 max_steps=attempts)
    ry, rst, rns, rnf = T._port(case, max_steps=attempts)
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


def _erk_host(lib, span, y0, **kw):
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = lib.fused_erk_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 5 + [ci, cf, cf, cf, cf, cf, ci, cf, ci, ci, ci,
                              vp]
    fn(y0.ctypes.data, out.ctypes.data, st.ctypes.data, ns.ctypes.data,
       nf.ctypes.data, nb, span[0], span[1], kw["rtol"], kw["atol"], 0.0, 1,
       np.inf,
       100_000, int(kw.get("compensated", False)), 128, None)
    return out, st, ns, nf


@pytest.mark.parametrize("label", ["vdp", "vdp_template"])
@pytest.mark.parametrize("case", ["vdp_plain", "vdp_compensated"])
def test_erk_kernel_matches_plain_version(libs, label, case):
    """The explicit kernel on the shared headers, with a plain and with a
    template right-hand side.  Measured: |dy| <= 1.5e-6, identical step
    counts, one member 7 RHS evaluations apart (compensated)."""
    prob, meth, span, y0, kw = TK.CASES[case]
    y, st, ns, nf = _erk_host(libs[label], span, y0, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in FK.fused_erk_reference(
        TK.PROBLEMS[prob], span, torch.tensor(y0), method=TK.BS5, **kw))
    np.testing.assert_array_equal(st, rst)
    assert np.max(np.abs(y - ry)) <= 3e-6
    np.testing.assert_array_equal(ns, rns)
    assert np.max(np.abs(nf - rnf)) <= 14


def _adams_host(lib, case, **over):
    """The host-built SWAG kernel on ``case``, started from the float32
    stepper's init as the wrapper starts it."""
    prob, span, y0, kw = ADAMS_CASES[case]
    kw = dict(kw, **over)
    rhs = TA.PROBLEMS[prob]
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    _, s0, direction = FA._host_init(
        rhs.torch_fn, span, torch.tensor(y0).T, kw["rtol"], kw["atol"],
        kw.get("first_step"), kw["k_max"], None)
    yp0 = np.ascontiguousarray(s0.yp.T.numpy())
    h0 = np.ascontiguousarray(s0.h.numpy())
    nfev0 = np.ascontiguousarray(s0.nfev.numpy())
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = lib.fused_adams_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 8 + [ci, cf, cf, cf, cf, cf, cf, ci, ci, ci, vp]
    fn(y0.ctypes.data, yp0.ctypes.data, h0.ctypes.data, nfev0.ctypes.data,
       out.ctypes.data, st.ctypes.data, ns.ctypes.data, nf.ctypes.data, nb,
       FA._f32(span[0]), FA._f32(span[1]), direction, FA._f32(kw["rtol"]),
       FA._f32(kw["atol"]), np.inf, kw.get("max_steps", 200_000),
       int(kw.get("compensated", False)), 128, None)
    return out, st, ns, nf


def _adams_plain(case, **over):
    prob, span, y0, kw = ADAMS_CASES[case]
    return tuple(r.numpy() for r in FA.fused_adams_reference(
        TA.PROBLEMS[prob], span, torch.tensor(y0), **dict(kw, **over)))


@pytest.mark.parametrize("case,attempts", [("vdp", 2), ("bench", 4),
                                           ("osc_comp", 200_000),
                                           ("decay_1e6", 200_000),
                                           ("bench12", 200_000)])
def test_adams_kernel_first_attempts_bit_identical(libs, case, attempts):
    """The kernel's attempts (the coefficient update, predictor, error
    estimates, corrector, order selection and the double-single carries,
    plain and compensated) repeat the plain version's arithmetic bit for
    bit until a step ratio taken by powf rounds differently from
    torch.pow: after 2 attempts on vdp and 4 on bench; never in the whole
    runs of osc_comp, decay_1e6 and bench12 (k_max = 12, 134 steps)."""
    y, st, ns, nf = _adams_host(libs["adams_" + case], case,
                                max_steps=attempts)
    ry, rst, rns, rnf = _adams_plain(case, max_steps=attempts)
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# vdp 1.5e-5, 1, 2; bench 7.6e-10, 0, 1; the rest 0, 0, 0.  Gates about
# 2x, with a floor of 1e-7 on |dy|.
GATES_ADAMS = [("vdp", 3e-5, 2, 4), ("osc_comp", 1e-7, 1, 2),
               ("decay_1e6", 1e-7, 1, 2), ("bench", 2e-9, 1, 2),
               ("bench12", 1e-7, 1, 2)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers", GATES_ADAMS)
def test_adams_kernel_matches_plain_version(libs, case, y_gate, dsteps,
                                            nmembers):
    y, st, ns, nf = _adams_host(libs["adams_" + case], case)
    ry, rst, rns, rnf = _adams_plain(case)
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers
