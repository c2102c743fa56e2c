"""Double-single (hi, lo) float32 arithmetic.

Counterpart of ``extensisq_tpu/ops/ds.py``: error-free transformations
(Knuth's two-sum, Dekker's split and two-product) in plain float32, so a
DS value ``hi + lo`` with ``|lo| <= ulp(hi)/2`` carries about 48
significand bits.  The fused RKC kernel's plain version runs its
Chebyshev coefficient recurrences with these; the kernel's device twin is
``csrc/ds.cuh``.

Every function works on float32 tensors of any shape (0-d included).
PyTorch runs each operation as its own rounded kernel, so nothing is
contracted into an FMA and the error terms are exact.  DS values are
plain ``(hi, lo)`` tuples.
"""
import torch

_SPLIT = 4097.0          # 2**12 + 1: Dekker splitter for float32 (24-bit)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no branch)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def split(a):
    """Dekker split: a = a_hi + a_lo with 12-bit halves."""
    c = _SPLIT * a
    a_hi = c - (c - a)
    return a_hi, a - a_hi


def two_prod(a, b):
    """Error-free a * b = p + e via Dekker splitting."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def ds(x):
    """Lift a float32 value to DS."""
    return x, torch.zeros_like(x)


def ds_neg(a):
    return -a[0], -a[1]


def ds_add(a, b):
    """DS + DS (Dekker/Linnainmaa add)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return two_sum(s, e)


def ds_add_f(a, x):
    """DS + float32."""
    s, e = two_sum(a[0], x)
    e = e + a[1]
    return two_sum(s, e)


def ds_mul(a, b):
    """DS * DS."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return two_sum(p, e)


def ds_mul_f(a, x):
    """DS * float32."""
    p, e = two_prod(a[0], x)
    e = e + a[1] * x
    return two_sum(p, e)


def ds_div(a, b):
    """DS / DS by one Newton correction of the float32 quotient."""
    q1 = a[0] / b[0]
    # r = a - q1*b in DS
    p, e = two_prod(q1, b[0])
    r_hi, r_e = two_sum(a[0], -p)
    r = r_hi + (r_e + a[1] - e - q1 * b[1])
    q2 = r / b[0]
    return two_sum(q1, q2)


def ds_collapse(a):
    """Round DS to float32."""
    return a[0] + a[1]
