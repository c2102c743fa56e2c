"""Stepper construction: dispatch a Method handle to its implementation.

Only the explicit Runge-Kutta family is ported; every other family of
the JAX package names the ROADMAP item that brings it.
"""

_NOT_PORTED = {
    "ckdisc": "A14",
    "rkn": "A11",
    "esdirk": "A8",
    "adams": "A9",
    "rkc": "A13",
}


def build_stepper(method, fun, n, dtype, **options):
    """The stepper for ``method``; ``options`` may set ``sc_params`` (the
    controller preset or 4-tuple).  The JAX package's dense-output
    options (``interpolant``, ``carry_stages``) have no use before dense
    output is ported and are ignored."""
    family = method.family
    merged = dict(method.options or {})
    merged.update(options)
    if family == "erk":
        from .erk import ERKStepper
        return ERKStepper(fun, method.tableau, n, dtype,
                          sc_params=merged.get("sc_params"))
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {family!r} family is not ported yet: ROADMAP item "
            f"{_NOT_PORTED[family]}")
    raise ValueError(f"unknown method family {family!r}")
