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
import test_torch_fused_erk_grid as TG  # noqa: E402
import test_torch_fused_rkc as TR  # noqa: E402
import test_torch_fused_rkn as TN  # noqa: E402

from extensisq_tpu_torch.ops import _build  # noqa: E402
from extensisq_tpu_torch.ops import fused_adams as FA  # noqa: E402
from extensisq_tpu_torch.ops import fused_erk as FK  # noqa: E402
from extensisq_tpu_torch.ops import fused_esdirk as FE  # noqa: E402
from extensisq_tpu_torch.ops import fused_rkc as FR  # noqa: E402
from extensisq_tpu_torch.ops import fused_rkn as FN  # noqa: E402
from extensisq_tpu_torch.parallel import pde  # noqa: E402

SHIM = """
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct HostDim3 { int x; };
static HostDim3 blockIdx, blockDim, threadIdx;
__attribute__((noinline)) static float __fadd_rn(float a, float b) {
  volatile float r = a + b; return r; }
__attribute__((noinline)) static float __fsub_rn(float a, float b) {
  volatile float r = a - b; return r; }
__attribute__((noinline)) static float __fmul_rn(float a, float b) {
  volatile float r = a * b; return r; }
__attribute__((noinline)) static float __fdiv_rn(float a, float b) {
  volatile float r = a / b; return r; }
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

# The RKC body integrate<RHO, Group> run by a one-thread group whose sync()
# does nothing, one member after another; the CUDA groups and kernels after
# the marker are left out.
RKC_MARKER = "// ---- CUDA groups, kernels and launch ----"
RKC_LAUNCH = """
struct HostGroup {
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  float sum(float v) const { return v; }
};

extern "C" int fused_rkc_host(
    int rho_mode, const float* y0, const float* params, float* y_out,
    int* status, int* nsteps, int* nfev, int* nfesig, float* work,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float h0, float rho_const, float max_step, int mmax, int max_steps,
    int const_jac) {
  Solve s{t0, tf, dir, rtol, atol, h0, rho_const, max_step,
          mmax, max_steps, const_jac};
  Out out{y_out, status, nsteps, nfev, nfesig};
  for (int m = 0; m < members; ++m) {
    HostGroup g;
    const float* p = tab::NPAR ? params + m * tab::NPAR : nullptr;
    const float* y = y0 + m * NTOT;
    float* w = work + static_cast<size_t>(m) * kArrays * NTOT;
    if (rho_mode == kRhoConst) integrate<kRhoConst>(g, y, p, w, s, m, out);
    if (rho_mode == kRhoFn) integrate<kRhoFn>(g, y, p, w, s, m, out);
    if (rho_mode == kRhoPower) integrate<kRhoPower>(g, y, p, w, s, m, out);
  }
  return 0;
}
"""
RKC_SHAPE = (8, 8)

RKN_LAUNCH = """
extern "C" int fused_rkn_launch(
    const void* y0, void* y_out, void* status, void* nstep, void* nfev,
    int B, float t0, float tf, float rtol, float atol, float h0,
    int use_hstart, float max_step, int max_steps, int compensated,
    void* stream) {
  blockDim.x = 1;
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    threadIdx.x = 0;
    auto k = compensated ? fused_rkn_kernel<true> : fused_rkn_kernel<false>;
    k((const float*)y0, (float*)y_out, (int*)status, (int*)nstep,
      (int*)nfev, B, t0, tf, rtol, atol, h0, use_hstart, max_step,
      max_steps);
  }
  return 0;
}
"""

# The grid body integrate<COMP, Group> (B4 and B6) run by a one-thread group
# on a host buffer in place of shared memory, one member after another.
GRID_LAUNCH = """
struct HostGroup {
  int rank() const { return 0; }
  int size() const { return 1; }
  void sync() const {}
  float sum(float v) const { return v; }
  float min(float v) const { return v; }
};

extern "C" int fused_rk_grid_host(
    const float* y0, float* y_out, int* status, int* nsteps, int* nfev,
    int members, float t0, float tf, float dir, float rtol, float atol,
    float h0, int use_hstart, float max_step, int max_steps,
    int compensated) {
  const Launch L{t0, tf, dir, rtol, atol, h0, use_hstart, max_step,
                 max_steps};
  const Out out{y_out, status, nsteps, nfev};
  float* sm = new float[kFloats];
  for (int m = 0; m < members; ++m) {
    HostGroup g;
    if (compensated) {
      integrate<true>(g, sm, y0 + m * NF, L, m, out);
    } else {
      integrate<false>(g, sm, y0 + m * NF, L, m, out);
    }
  }
  delete[] sm;
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


def _compile(name, header, launch, out_dir, cut='extern "C"'):
    src = (_build.CSRC / f"{name}.cu").read_text()
    for inc in ("#include <cuda_runtime.h>",
                "#include <cooperative_groups.h>"):
        src = src.replace(inc, "")
    src = src[:src.index(cut)] + launch
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
    rkc_p = pde.brusselator_2d_grid(RKC_SHAPE, B=None)
    jobs["rkc"] = ("fused_rkc", _build.fused_rkc_header(
        rkc_p.shape, 1, rkc_p.cuda_src, TR.RHO_FN.cuda_src), RKC_LAUNCH,
        RKC_MARKER)
    jobs["rkn_kepler"] = ("fused_rkn", _build.fused_rkn_header(
        FN.rkn_consts(TN.Fi5N), 2, TN.KEPLER.cuda_src), RKN_LAUNCH)
    jobs["grid_wave"] = ("fused_rk_grid", _build.fused_rk_grid_header(
        FN.rkn_consts(TN.Fi5N), True, (TN.N_GRID,), TN.WAVE_CUDA),
        GRID_LAUNCH, RKC_MARKER)
    jobs["grid_fisher"] = ("fused_rk_grid", _build.fused_rk_grid_header(
        FK._fused_consts(TK.BS5), False, (TG.N,), TG.RHS["fisher"].cuda_src),
        GRID_LAUNCH, RKC_MARKER)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_compile, *v[:3], d / k, *v[3:])
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


def _rkc_inputs():
    x = np.linspace(0, 1, RKC_SHAPE[1], endpoint=False)
    y0 = np.zeros((3, 2) + RKC_SHAPE, np.float32)
    for i, a in enumerate((0.2, 0.35, 0.5)):
        y0[i, 0] = 1.0 + a * np.sin(2 * np.pi * x)[None, :]
        y0[i, 1] = 3.0
    y0[2] *= 1e30                      # this member overflows
    return y0, np.array([[2.9], [3.2], [3.4]], np.float32)


def _rkc_host(lib, rho_mode, rho, **kw):
    y0, params = _rkc_inputs()
    nb = y0.shape[0]
    ntot = int(np.prod(y0.shape[1:]))
    out = np.empty_like(y0)
    ints = [np.empty(nb, np.int32) for _ in range(4)]
    work = np.empty(nb * FR.N_ARRAYS * ntot, np.float32)
    fn = lib.fused_rkc_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ci] + [vp] * 8 + [ci] + [cf] * 8 + [ci] * 3
    fn(rho_mode, y0.ctypes.data, params.ctypes.data, out.ctypes.data,
       *[a.ctypes.data for a in ints], work.ctypes.data, nb, 0.0, 1.0, 1.0,
       1e-4, 1e-7, FR._f32(kw.get("first_step", -1.0)),
       FR._f32(rho) if rho_mode == 0 else 0.0, np.inf,
       FR._mmax_for(1e-4, kw.get("m_max"))[0], 100_000,
       int(kw.get("const_jac", False)))
    return (out, *ints)


RHO_8 = 8 * 0.02 * RKC_SHAPE[1] ** 2 + 5.5


# (rho mode, options): the three ways to the spectral radius, const_jac
# and a forced stage cap
RKC_CASES = {"float": (0, {}), "callable": (1, {}), "power": (2, {}),
             "power_const_jac": (2, {"const_jac": True}),
             "m_max": (0, {"m_max": 2})}


@pytest.mark.parametrize("case", list(RKC_CASES))
def test_rkc_kernel_matches_plain_version(libs, case):
    """The RKC body (B9 and B10 share it) run on the host by a one-thread
    group against fused_rkc_reference on three 2x8x8 Brusselator members
    with their own B, one of which overflows.  Measured: identical status,
    nsteps, nfev and nfesig, |dy| <= 1.4e-6 over the finished members (the
    libraries' logf/sinhf/coshf/powf and the order of the grid sums, which
    the host kernel takes sequentially); the gate is 5e-6."""
    mode, kw = RKC_CASES[case]
    rho = {0: RHO_8, 1: TR.RHO_FN, 2: None}[mode]
    y, st, ns, nf, nsig = _rkc_host(libs["rkc"], mode, RHO_8, **kw)
    y0, params = _rkc_inputs()
    ref = FR.fused_rkc_reference(
        pde.brusselator_2d_grid(RKC_SHAPE, B=None), (0.0, 1.0),
        torch.tensor(y0), rho, params=torch.tensor(params), rtol=1e-4,
        atol=1e-7, **kw)
    ref = [r.numpy() for r in ref]
    np.testing.assert_array_equal(st, ref[1])
    assert list(st) == [1, 1, 3 if mode != 2 else 6]
    np.testing.assert_array_equal(ns, ref[2])
    np.testing.assert_array_equal(nf, ref[3])
    if mode == 2:
        np.testing.assert_array_equal(nsig, ref[4])
    assert np.max(np.abs(y[:2] - ref[0][:2])) <= 5e-6


def _rkn_host(lib, span, y0, **kw):
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = lib.fused_rkn_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 5 + [ci, cf, cf, cf, cf, cf, ci, cf, ci, ci, vp]
    fn(y0.ctypes.data, out.ctypes.data, st.ctypes.data, ns.ctypes.data,
       nf.ctypes.data, nb,
       *FK.launch_args(span, kw["rtol"], kw["atol"], kw.get("first_step"),
                       kw.get("max_steps", 100_000),
                       kw.get("compensated", False), None), None)
    return out, st, ns, nf


def _grid_host(lib, span, y0, **kw):
    y0 = np.ascontiguousarray(y0, np.float32)
    nb = y0.shape[0]
    out = np.empty_like(y0)
    st, ns, nf = (np.empty(nb, np.int32) for _ in range(3))
    fn = lib.fused_rk_grid_host
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 5 + [ci] + [cf] * 6 + [ci, cf, ci, ci]
    t0, tf, rt, at, h0, use_h, mstep, msteps, comp = FK.launch_args(
        span, kw["rtol"], kw["atol"], kw.get("first_step"),
        kw.get("max_steps", 100_000), kw.get("compensated", False), None)
    fn(y0.ctypes.data, out.ctypes.data, st.ctypes.data, ns.ctypes.data,
       nf.ctypes.data, nb, t0, tf, float(np.sign(tf - t0)), rt, at, h0,
       use_h, mstep, msteps, comp)
    return out, st, ns, nf



def _new_case(label):
    """(host runner, library, plain version, right-hand side, span, y0,
    options) of a case of the RKN and grid kernels."""
    case = {"kepler": (_rkn_host, "rkn_kepler", FN.fused_rkn_reference,
                       TN.KEPLER, TN.CASES),
            "wave": (_grid_host, "grid_wave", TN.fused_rkn_grid_reference,
                     TN.WAVE, TN.CASES),
            "fisher": (_grid_host, "grid_fisher",
                       TG.fused_erk_grid_reference, TG.RHS["fisher"],
                       TG.CASES)}[label.split("_")[0]]
    host, lib, plain, fun, cases = case
    c = cases[label]
    return host, lib, plain, fun, c[-3], c[-2], dict(c[-1])


# (case, max |dy|, max |dnsteps|, members with other counts), measured:
# kepler_plain 9.6e-5, 1, 7; kepler_comp 2.8e-5, 1, 71 (B5, Fi5N, the
# f32 error estimate of a nearly circular orbit is round-off, so last bits
# move h); wave_h0 1.1e-4, 0, 0; wave_comp 1.3e-5, 1, 1 (B6, n = 100);
# fisher_plain 1.8e-4, 5, 3; fisher_comp 5.3e-6, 3, 5; fisher_h0 8.3e-7,
# 0, 0 (B4, n = 100).  Gates about 2x.
NEW_GATES = [("kepler_plain", 2e-4, 2, 16), ("kepler_comp", 6e-5, 2, 100),
             ("wave_h0", 2e-4, 0, 0), ("wave_comp", 3e-5, 2, 2),
             ("fisher_plain", 4e-4, 8, 6), ("fisher_comp", 1.2e-5, 6, 8),
             ("fisher_h0", 2e-6, 0, 0)]


@pytest.mark.parametrize("case,y_gate,dsteps,nmembers", NEW_GATES)
def test_rkn_and_grid_kernels_match_plain_versions(libs, case, y_gate,
                                                    dsteps, nmembers):
    """B5 (``fused_rkn.cu``, one member per thread) and the block body of
    B4 and B6 (``fused_rk_grid.cu``, run by a one-thread group) against
    their plain versions: status identical, counts within the gates (the
    libraries' powf/log10f part last bits of h), identical where
    ``first_step`` is given."""
    host, lib, plain, fun, span, y0, kw = _new_case(case)
    y, st, ns, nf = host(libs[lib], span, y0, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in plain(fun, span,
                                                  torch.tensor(y0), **kw))
    np.testing.assert_array_equal(st, rst)
    assert np.all(st == 1)
    assert np.max(np.abs(y - ry)) <= y_gate
    assert np.max(np.abs(ns - rns)) <= dsteps
    assert np.sum((ns != rns) | (nf != rnf)) <= nmembers


@pytest.mark.parametrize("case,attempts", [("wave_comp", 5), ("wave_h0", 1),
                                           ("fisher_h0", 1),
                                           ("fisher_comp", 1)])
def test_grid_body_first_attempts_bit_identical(libs, case, attempts):
    """With ``first_step`` given, the grid body's first attempts (stage
    sums, the compensated carries, the norm, the controller) repeat the
    plain version's arithmetic bit for bit: five attempts of the
    compensated wave, until powf and torch.pow round a step ratio apart."""
    host, lib, plain, fun, span, y0, kw = _new_case(case)
    kw.update(first_step=0.01, max_steps=attempts)
    y, st, ns, nf = host(libs[lib], span, y0, **kw)
    ry, rst, rns, rnf = (r.numpy() for r in plain(fun, span,
                                                  torch.tensor(y0), **kw))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(st, rst)
    np.testing.assert_array_equal(ns, rns)
    np.testing.assert_array_equal(nf, rnf)


@pytest.mark.parametrize("case", ["overflow", "wave_overflow"])
def test_rkn_kernels_isolate_an_overflowing_member(libs, tmp_path, case):
    """A member whose state overflows ends with status 3 alone, in the
    thread-per-member kernel (cubic acceleration) and in the block body
    (the wave plus a cubic term); the others keep the plain version's
    counts within a step (measured: identical, and one wave member one
    step apart from the starting step's last bits)."""
    kind, prob, meth, span, y0, kw = TN.CASES[case]
    fun = TN.CARD_PROBLEMS[prob]
    if kind == "flat":
        header = _build.fused_rkn_header(FN.rkn_consts(TN.Fi5N), fun.m,
                                         fun.cuda_src)
        lib = _compile("fused_rkn", header, RKN_LAUNCH, tmp_path / case)
        out = _rkn_host(lib, span, y0, **kw)
        plain = FN.fused_rkn_reference
    else:
        header = _build.fused_rk_grid_header(FN.rkn_consts(TN.Fi5N), True,
                                             (fun.n,), fun.cuda_src)
        lib = _compile("fused_rk_grid", header, GRID_LAUNCH,
                       tmp_path / case, RKC_MARKER)
        out = _grid_host(lib, span, y0, **kw)
        plain = TN.fused_rkn_grid_reference
    ref = [r.numpy() for r in plain(fun, span, torch.tensor(y0), **kw)]
    bad = 7 if kind == "flat" else 3
    assert out[1][bad] == 3 and np.sum(out[1] == 1) == len(y0) - 1
    np.testing.assert_array_equal(out[1], ref[1])
    ok = out[1] == 1
    assert np.max(np.abs(out[2][ok] - ref[2][ok])) <= 1
