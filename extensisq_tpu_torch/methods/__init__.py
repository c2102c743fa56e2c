"""Method registry of the port: the explicit Runge-Kutta methods, CKdisc
(Cash-Karp's variable-order cascade for non-smooth problems), the
Runge-Kutta-Nystrom pairs for second-order systems, the implicit ESDIRK
methods, SWAG, the variable-order Adams method, and SSV2stab, the
stabilized Runge-Kutta-Chebyshev method.
"""
from .erk import BS5, Ts5, CK5, CKdisc, Me4
from .erk_high import Pr7, Pr8, Pr9, CFMR7osc
from .rkn import Fi4N, Fi5N, Mu5Nmb, MR6NN
from .esdirk import TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I
from ..types import Method

SWAG = Method(name="SWAG", family="adams", options={"k_max": 12})
SSV2stab = Method(name="SSV2stab", family="rkc")

EXPLICIT_METHODS = [BS5, Ts5, CK5, Me4, Pr7, Pr8, Pr9, CFMR7osc]
RKN_METHODS = [Fi4N, Fi5N, Mu5Nmb, MR6NN]
ESDIRK_METHODS = [TRBDF2, TRX2, KC3I, KC4I, KC4Ia, Kv3I]

ALL_METHODS = (EXPLICIT_METHODS + [CKdisc] + RKN_METHODS + ESDIRK_METHODS
               + [SWAG, SSV2stab])

METHODS_BY_NAME = {m.name: m for m in ALL_METHODS}
METHODS_BY_NAME["HS2I"] = HS2I
METHODS_BY_NAME["HS2Ia"] = HS2Ia

__all__ = [
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "Fi4N", "Fi5N", "Mu5Nmb", "MR6NN", "RKN_METHODS",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "SSV2stab", "EXPLICIT_METHODS", "ESDIRK_METHODS", "ALL_METHODS",
    "METHODS_BY_NAME",
]
