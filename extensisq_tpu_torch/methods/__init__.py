"""Method registry of the port: the explicit Runge-Kutta methods, the
implicit ESDIRK methods and SWAG, the variable-order Adams method.

CKdisc's tableau comes along as data; its ``ckdisc`` family is not
ported yet (ROADMAP A14).
"""
from .erk import BS5, Ts5, CK5, CKdisc, Me4
from .erk_high import Pr7, Pr8, Pr9, CFMR7osc
from .esdirk import TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I
from ..types import Method

SWAG = Method(name="SWAG", family="adams", options={"k_max": 12})

EXPLICIT_METHODS = [BS5, Ts5, CK5, Me4, Pr7, Pr8, Pr9, CFMR7osc]
ESDIRK_METHODS = [TRBDF2, TRX2, KC3I, KC4I, KC4Ia, Kv3I]

METHODS_BY_NAME = {m.name: m for m in EXPLICIT_METHODS + [CKdisc]
                   + ESDIRK_METHODS + [SWAG]}
METHODS_BY_NAME["HS2I"] = HS2I
METHODS_BY_NAME["HS2Ia"] = HS2Ia

__all__ = [
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "EXPLICIT_METHODS", "ESDIRK_METHODS", "METHODS_BY_NAME",
]
