"""ctypes binding for the native sweep executor (csrc/sweep.cc).

Python-facing replacement for the reference's joblib fan-out
(experiments/regression.py:219-231): ``run_sweep(commands, jobs)`` executes
shell commands over a native thread pool with retries; returns per-task
(status, seconds).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from .build import lib_path

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(lib_path("libggp_sweep.so"))
        lib.ggp_sweep_run.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ggp_sweep_run.restype = ctypes.c_int
        _lib = lib
    return _lib


def run_sweep(commands: Sequence[str], jobs: int = 1, retries: int = 0,
              quiet: bool = True) -> Tuple[int, List[Tuple[int, float]]]:
    """Returns (num_failed, [(status, seconds), ...]).

    ``jobs`` defaults to 1 because each command is typically a JAX process,
    and a JAX process reserves most of the GPU's memory when it starts: a
    second one on the same card then fails for want of memory. Raise it
    only for commands that stay off the device or that are each given
    their share (``XLA_PYTHON_CLIENT_MEM_FRACTION``)."""
    lib = _get_lib()
    n = len(commands)
    arr = (ctypes.c_char_p * n)(*[c.encode() for c in commands])
    secs = (ctypes.c_double * n)()
    stat = (ctypes.c_int * n)()
    failed = lib.ggp_sweep_run(arr, n, jobs, retries, 1 if quiet else 0,
                               secs, stat)
    return failed, list(zip(list(stat), list(secs)))
