"""Stepper construction: dispatch a Method handle to its implementation.

The explicit Runge-Kutta, ESDIRK and SWAG (``adams``) families are
ported; every other family of the JAX package names the ROADMAP item
that brings it.
"""

_NOT_PORTED = {
    "ckdisc": "A14",
    "rkn": "A11",
    "rkc": "A13",
}


def build_stepper(method, fun, n, dtype, **options):
    """The stepper for ``method``.  ``options`` may set ``sc_params``
    (the controller preset or 4-tuple) and, for ESDIRK methods, ``jac``
    (a callable returning the rows-first ``(n, n, B)`` Jacobian, or a
    constant ``(n, n)`` array for linear problems), ``M`` (a constant
    mass matrix, ``(n,)`` diagonal or ``(n, n)``) and ``jac_each_step``.
    The JAX package's dense-output options (``interpolant``,
    ``carry_stages``) have no use before dense output is ported and are
    ignored.  SWAG takes ``k_max`` (1 to 12)."""
    family = method.family
    merged = dict(method.options or {})
    merged.update(options)
    if family == "erk":
        from .erk import ERKStepper
        return ERKStepper(fun, method.tableau, n, dtype,
                          sc_params=merged.get("sc_params"))
    if family == "esdirk":
        for name in ("bands", "jac_sparsity"):
            if merged.get(name) is not None:
                raise NotImplementedError(
                    f"ESDIRK {name}=...: banded and sparse Jacobians are not "
                    "ported yet: ROADMAP item A8b")
        from .esdirk import ESDIRKStepper
        return ESDIRKStepper(fun, method.tableau, n, dtype,
                             sc_params=merged.get("sc_params"),
                             jac=merged.get("jac"), M=merged.get("M"),
                             jac_each_step=merged.get("jac_each_step",
                                                      False))
    if family == "adams":
        from .adams import AdamsStepper
        return AdamsStepper(fun, n, dtype,
                            options={"k_max": merged.get("k_max", 12)})
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {family!r} family is not ported yet: ROADMAP item "
            f"{_NOT_PORTED[family]}")
    raise ValueError(f"unknown method family {family!r}")
