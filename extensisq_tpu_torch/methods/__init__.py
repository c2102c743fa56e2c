"""Method registry of the port: the explicit Runge-Kutta methods.

CKdisc's tableau comes along as data; its ``ckdisc`` family is not
ported yet (ROADMAP A14).
"""
from .erk import BS5, Ts5, CK5, CKdisc, Me4
from .erk_high import Pr7, Pr8, Pr9, CFMR7osc

EXPLICIT_METHODS = [BS5, Ts5, CK5, Me4, Pr7, Pr8, Pr9, CFMR7osc]

METHODS_BY_NAME = {m.name: m for m in EXPLICIT_METHODS + [CKdisc]}

__all__ = [
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "EXPLICIT_METHODS", "METHODS_BY_NAME",
]
