"""Child-process lifetime hygiene (counterpart of
``vsc2022_tpu/utils/procs.py``).

A child that outlives a SIGKILLed parent (a harness killed at its
deadline) keeps its device memory and its CPU. Every process the port
spawns sets PR_SET_PDEATHSIG, so the kernel kills it when its parent
dies: no reaping code can be skipped by a SIGKILL.
"""

from __future__ import annotations

import os
import signal
import sys

PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """preexec_fn (or a worker's first call): SIGKILL this process when
    its parent dies (Linux; a no-op elsewhere). The getppid check after
    the call closes the race where the parent died first (the signal
    fires only for deaths after the call)."""
    if sys.platform != "linux":
        return
    import ctypes

    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() == 1:
        os._exit(1)
