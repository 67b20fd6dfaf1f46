"""Checkpoint on preemption: SIGTERM or SIGUSR1 becomes one clean save and
a stop.

JAX counterpart, copied: ``onedc_tpu/utils/preempt.py``
(``PreemptionGuard`` :35-73). The trainer polls ``triggered`` once per
step and saves once before it returns, so a preempted run resumes from
the step it was cut at. SIGINT keeps its default meaning.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

log = logging.getLogger("onedc_tpu_torch.preempt")


class PreemptionGuard:
    """Context manager installing save-and-exit signal handlers.

    Not nested; restores the previous handlers on exit. Outside the main
    thread (where CPython forbids ``signal.signal``) it is inert, with a
    warning: training goes on without the protection.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGUSR1)):
        self._signals = tuple(signals)
        self._old: dict = {}
        self._event = threading.Event()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):  # noqa: ARG002 (signal API)
        log.warning("received signal %d: will checkpoint and stop after "
                    "the current step", signum)
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                log.warning("cannot install handler for signal %d outside "
                            "the main thread; preemption guard inactive", s)
                break
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old.clear()
        return False
