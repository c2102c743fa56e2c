"""Status codes and step-size constants, as in ``extensisq_tpu/_config.py``.

The JAX package switches x64 on here; PyTorch needs no switch: a solve
runs in the dtype of its ``y0`` tensor.
"""

# Step-size limiter constants, cf. extensisq ``common.py``
MIN_FACTOR = 0.2
MAX_FACTOR = 4.0
MAX_FACTOR0 = 10.0

# Newton iteration constants for implicit (ESDIRK) methods
NEWTON_MAXITER = 5
MAX_RATE = 0.2
MAX_FACTOR_NRF = 0.5

# Status codes carried per member as int32
RUNNING = 0
FINISHED = 1
TOO_SMALL_STEP = 2
OVERFLOW = 3
MAX_STEPS_REACHED = 4
NEWTON_FAIL = 5
RHO_FAIL = 6
TOL_TOO_TIGHT = 7
TERMINAL_EVENT = 8
PAUSED = 9               # window boundary reached; state is resumable

STATUS_MESSAGES = {
    RUNNING: "running",
    FINISHED: "The solver successfully reached the end of the integration "
              "interval.",
    TOO_SMALL_STEP: "Required step size is less than spacing between "
                    "numbers.",
    OVERFLOW: "Overflow or underflow encountered.",
    MAX_STEPS_REACHED: "Maximum number of steps reached.",
    NEWTON_FAIL: "Newton iterations failed to converge.",
    RHO_FAIL: "The method to estimate the spectral radius of the Jacobian "
              "did not converge",
    TOL_TOO_TIGHT: "tolerance too tight.",
    TERMINAL_EVENT: "A termination event occurred.",
    PAUSED: "Paused at a window boundary; resume with resume_state.",
}
