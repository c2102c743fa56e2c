"""Stepper construction: dispatch a Method handle to its implementation.

Every family of the JAX package is ported: the explicit Runge-Kutta,
Runge-Kutta-Nystrom (``rkn``), CKdisc (``ckdisc``), ESDIRK, SWAG
(``adams``) and SSV2stab (``rkc``) families.
"""


def build_stepper(method, fun, n, dtype, **options):
    """The stepper for ``method``.  ``options`` may set ``sc_params``
    (the controller preset or 4-tuple) and, for ESDIRK methods, ``jac``
    (a callable returning the rows-first ``(n, n, B)`` Jacobian, or a
    constant ``(n, n)`` array for linear problems), ``M`` (a constant
    mass matrix, ``(n,)`` diagonal or ``(n, n)``), ``jac_each_step``,
    ``jac_sparsity`` (a 0/1 pattern: the Jacobian from one JVP per column
    group) and ``bands`` (``(kl, ku)``, ``True`` or ``"rcm"``: the Newton
    matrices factored by block cyclic reduction, ``core/banded.py``).
    The explicit families (ERK, RKN, CKdisc) take ``carry_stages``, which
    keeps the last accepted step's start and stages for dense output,
    events and the stiffness check (``solve`` sets it when they are
    asked for), and ERK, RKN and ESDIRK ``interpolant`` (the default of
    ``dense_segments``); ERK and RKN steppers keep the merged options as
    ``options`` (the host driver's stiffness check reads
    ``nfev_stiff_detect`` there).  RKN methods take ``scale_embedded``
    (Mu5Nmb's default damps the embedded estimate by 0.75).  SWAG takes ``k_max``
    (1 to 12); SSV2stab takes ``rho_jac`` (a spectral-radius bound
    ``rho_jac(t, y)``) and ``const_jac``."""
    family = method.family
    merged = dict(method.options or {})
    merged.update(options)
    if family == "erk":
        from .erk import ERKStepper
        return ERKStepper(fun, method.tableau, n, dtype,
                          sc_params=merged.get("sc_params"),
                          carry_stages=merged.get("carry_stages", False),
                          interpolant=merged.get("interpolant"),
                          options=merged)
    if family == "ckdisc":
        from .ckdisc import CKdiscStepper
        return CKdiscStepper(fun, method.tableau, n, dtype,
                             data=merged["ckdisc"],
                             carry_stages=merged.get("carry_stages", False))
    if family == "rkn":
        from .rkn import RKNStepper
        return RKNStepper(fun, method.tableau, n, dtype,
                          sc_params=merged.get("sc_params"),
                          scale_embedded=bool(merged.get("scale_embedded")),
                          carry_stages=merged.get("carry_stages", False),
                          interpolant=merged.get("interpolant"),
                          options=merged)
    if family == "esdirk":
        from .esdirk import ESDIRKStepper
        return ESDIRKStepper(fun, method.tableau, n, dtype,
                             sc_params=merged.get("sc_params"),
                             jac=merged.get("jac"), M=merged.get("M"),
                             jac_each_step=merged.get("jac_each_step",
                                                      False),
                             interpolant=merged.get("interpolant"),
                             bands=merged.get("bands"),
                             jac_sparsity=merged.get("jac_sparsity"))
    if family == "adams":
        from .adams import AdamsStepper
        return AdamsStepper(fun, n, dtype,
                            options={"k_max": merged.get("k_max", 12)})
    if family == "rkc":
        from .rkc import RKCStepper
        return RKCStepper(fun, n, dtype, options={
            "rho_jac": merged.get("rho_jac"),
            "const_jac": merged.get("const_jac", False)})
    raise ValueError(f"unknown method family {family!r}")
