"""Core data types: Butcher tableaux as frozen numpy data, solve
parameters and the user-facing ``Method`` handle.

Counterpart of ``extensisq_tpu/types.py``.  A method is pure data: a
frozen tableau whose arrays are host constants of every solve (and of
the generated CUDA header of the fused kernel), plus a ``Method`` handle
the user passes to ``solve``/``solve_ensemble``/``solve_fused_erk``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np


def _freeze(a):
    if a is None:
        return None
    a = np.asarray(a, dtype=float)
    a.setflags(write=False)
    return a


@dataclasses.dataclass(frozen=True)
class ERKTableau:
    """Embedded explicit Runge-Kutta pair (+ optional interpolants).

    ``A`` (s, s) strictly lower triangular, ``B``/``C`` (s,), error
    weights ``E`` (s+1,) with ``E[-1] != 0`` iff the pair is FSAL,
    interpolant ``P`` (s+1, p).
    """
    name: str
    order: int
    order_secondary: int
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    E: np.ndarray
    P: Optional[np.ndarray] = None
    # two-phase error test (BS5 / CFMR7osc): error check after n_pre stages
    n_pre: int = 0
    E_pre: Optional[np.ndarray] = None          # (n_pre,)
    B_pre: Optional[np.ndarray] = None          # (n_pre,) scale-solution wts
    # extra stages for higher-accuracy interpolants, keyed by option name
    interpolants: Any = None
    # stiffness-detection stability-arc parameters (None = not implemented)
    stbrad: Optional[float] = None
    tanang: Optional[float] = None
    sc_params: str = "standard"

    def __post_init__(self):
        for f in ("A", "B", "C", "E", "P", "E_pre", "B_pre"):
            object.__setattr__(self, f, _freeze(getattr(self, f)))

    @property
    def n_stages(self):
        return self.B.shape[0]

    @property
    def fsal(self):
        return bool(self.E[self.n_stages] != 0.0)

    def c_spacing(self):
        """Minimum distance between distinct C nodes, for the min-step
        rule (extensisq ``common.py``)."""
        cdiff = 1.0
        for c1 in self.C:
            for c2 in self.C:
                d = abs(c1 - c2)
                if d:
                    cdiff = min(cdiff, d)
        return max(cdiff, 1e-3)


@dataclasses.dataclass(frozen=True)
class RKNTableau:
    """Explicit Runge-Kutta-Nystrom pair for u'' = a(t, u[, u']).

    Displacement weights ``A``/``B``/``E`` act with h^2, velocity weights
    ``Ap``/``Bp``/``Ep`` with h.  ``Ap`` is None for velocity-independent
    (strict RKN) methods; ``Ep[-1] != 0`` iff the pair is FSAL.  ``P``/``Pp``
    and ``interpolants`` are the dense-output data.
    """
    name: str
    order: int
    order_secondary: int
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    E: np.ndarray
    Ap: Optional[np.ndarray]
    Bp: np.ndarray
    Ep: np.ndarray
    P: Optional[np.ndarray] = None
    Pp: Optional[np.ndarray] = None
    interpolants: Any = None
    stbre: Optional[float] = None
    stbim: Optional[float] = None
    tanang: Optional[float] = None
    sc_params: str = "G"

    def __post_init__(self):
        for f in ("A", "B", "C", "E", "Ap", "Bp", "Ep", "P", "Pp"):
            object.__setattr__(self, f, _freeze(getattr(self, f)))

    @property
    def n_stages(self):
        return self.B.shape[0]

    @property
    def fsal(self):
        return bool(self.Ep[self.n_stages] != 0.0)

    @property
    def velocity_independent(self):
        return self.Ap is None

    c_spacing = ERKTableau.c_spacing


@dataclasses.dataclass(frozen=True)
class ESDIRKTableau:
    """Explicit-first-stage singly-diagonal implicit RK tableau.

    ``d`` is the diagonal entry, ``Az`` the stage-increment predictor
    weights and ``kappa`` the Newton tolerance factor.  ``filter_error``
    selects the filtered error estimate (TR-BDF2 and TRX2), and
    ``piecewise_cubic_dense`` their three-point dense output.
    """
    name: str
    order: int
    order_secondary: int
    d: float
    kappa: float
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    E: np.ndarray
    Az: np.ndarray
    P: Optional[np.ndarray] = None            # default interpolant
    interpolants: Any = None                  # {'C0': P0, 'C1': P1}
    filter_error: bool = False
    piecewise_cubic_dense: bool = False
    sc_params: str = "G"

    def __post_init__(self):
        for f in ("A", "B", "C", "E", "Az", "P"):
            object.__setattr__(self, f, _freeze(getattr(self, f)))

    @property
    def n_stages(self):
        return self.B.shape[0]

    c_spacing = ERKTableau.c_spacing


def tableau_from_arrays(A, B, C, E, order, order_secondary, **extras):
    """Build an :class:`ERKTableau` from numpy arrays.

    The arrays may be the fields of any ``extensisq_tpu`` tableau, so a
    custom method defined for the JAX package runs unchanged here:
    ``tableau_from_arrays(t.A, t.B, t.C, t.E, t.order,
    t.order_secondary, name=t.name, sc_params=t.sc_params)``.
    ``extras`` are the remaining :class:`ERKTableau` fields (``name``
    defaults to ``"custom"``).
    """
    extras.setdefault("name", "custom")
    fields = {f.name for f in dataclasses.fields(ERKTableau)}
    unknown = set(extras) - fields
    if unknown:
        raise TypeError(f"unknown ERKTableau fields: {sorted(unknown)}")
    return ERKTableau(order=int(order), order_secondary=int(order_secondary),
                      A=np.asarray(A), B=np.asarray(B), C=np.asarray(C),
                      E=np.asarray(E), **extras)


class IVPParams(NamedTuple):
    """Per-solve parameters shared by all steppers.

    ``t_bound``, ``direction``, ``rtol`` and ``max_step`` are Python
    floats; ``atol`` is a float or an ``(n, 1)`` tensor, so it
    broadcasts against the rows-first ``(n, B)`` state.
    """
    t_bound: Any
    direction: Any           # +1.0 / -1.0
    rtol: Any
    atol: Any
    max_step: Any


@dataclasses.dataclass(frozen=True)
class Method:
    """User-facing handle: ``solve(fun, span, y0, method=BS5)``.

    ``family`` selects the stepper implementation; ``tableau`` holds the
    data; ``options`` are method-specific defaults that can be overridden
    per solve.
    """
    name: str
    family: str              # 'erk' | 'ckdisc' | 'rkn' | 'esdirk' | 'adams' | 'rkc'
    tableau: Any = None
    options: Any = None

    def with_options(self, **opts):
        merged = dict(self.options or {})
        merged.update(opts)
        return dataclasses.replace(self, options=merged)

    def __call__(self, fun, t0, y0, t_bound, **options):
        """The scipy ``OdeSolver`` stepwise protocol:
        ``BS5(fun, t0, y0, t_bound).step()`` (an
        :class:`extensisq_tpu_torch.ivp.Stepper`)."""
        from .ivp import Stepper
        return Stepper(self, fun, t0, y0, t_bound, **options)

    def __repr__(self):
        return f"<extensisq_tpu_torch method {self.name}>"
