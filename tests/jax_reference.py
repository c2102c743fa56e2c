"""Run a JAX reference script for the port's tests in subprocesses
without FMA (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``), several at once."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run_jax(script, d, parts, warm=()):
    """Run ``script`` (argv: ``d/in.npz``, a JSON spec, an output path) on
    each spec of ``parts`` in its own subprocess, all at once, calling each
    of ``warm`` meanwhile; returns the merged outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", PYTHONPATH=str(REPO))
    procs = [(subprocess.Popen([sys.executable, "-c", script,
                                str(d / "in.npz"), json.dumps(spec),
                                str(d / f"out{i}.npz")], cwd=REPO, env=env),
              d / f"out{i}.npz") for i, spec in enumerate(parts)]
    try:
        for fn in warm:
            fn()
    finally:
        codes = [proc.wait(timeout=600) for proc, _ in procs]
    assert codes == [0] * len(procs), codes
    out = {}
    for _, path in procs:
        out.update(np.load(path))
    return out
