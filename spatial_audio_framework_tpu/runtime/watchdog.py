"""A watchdog that makes entry points un-losable.

A blocking device call has no timeout in plain JAX, and a Python signal
handler cannot run while the main thread is blocked inside one, so the
reliable recovery mechanism is a *separate watchdog thread* that observes
wall-clock progress and force-exits the process after emitting a
diagnostic.

:class:`Watchdog` is a daemon thread monitoring (a) a per-operation
deadline (``begin(name, timeout_s)`` / ``end()``) and (b) a global
wall-clock budget.  On expiry it calls the registered ``on_expire(reason)``
callback (e.g. print a partial result JSON) and then
``os._exit(exit_code)`` — ``os._exit`` because the blocked thread can never
be joined.

Reference analogue for the always-report discipline: the per-test timing of
/root/reference/test/src/saf_test.c:57-70 — numbers are printed even when a
test fails.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional


class Watchdog:
    """Daemon thread enforcing per-operation deadlines + a global budget.

    >>> wd = Watchdog(budget_s=720, on_expire=dump_partial_json)
    >>> wd.begin("flagship", timeout_s=300)   # hang here -> on_expire + exit
    >>> ...
    >>> wd.end()

    ``on_expire(reason: str)`` runs on the watchdog thread; keep it simple
    (print + flush).  After it returns the process exits with ``exit_code``
    (default 0: a diagnosed partial result is a *successful* report, and a
    reader must receive a parseable line rather than silence).
    """

    def __init__(self, on_expire: Callable[[str], None],
                 budget_s: Optional[float] = None,
                 exit_code: int = 0, poll_s: float = 0.5,
                 exit_fn: Callable[[int], None] = os._exit):
        self._on_expire = on_expire
        self._exit_code = exit_code
        self._exit_fn = exit_fn
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._op: Optional[str] = None
        self._op_deadline: Optional[float] = None
        self._op_timeout_s: Optional[float] = None
        self._budget_deadline = (time.monotonic() + budget_s
                                 if budget_s else None)
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="saf-watchdog")
        self._thread.start()

    def begin(self, name: str, timeout_s: float) -> None:
        with self._lock:
            self._op = name
            self._op_deadline = time.monotonic() + timeout_s
            self._op_timeout_s = timeout_s

    def end(self) -> None:
        with self._lock:
            self._op = None
            self._op_deadline = None
            self._op_timeout_s = None

    def budget_remaining_s(self) -> float:
        if self._budget_deadline is None:
            return float("inf")
        return self._budget_deadline - time.monotonic()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    # -- internals ----------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped:
            time.sleep(self._poll_s)
            now = time.monotonic()
            # expiry is DECIDED and latched under the same lock begin()/
            # end()/stop() take, so an op that completed (or a stop()) in
            # the last poll interval can never be force-exited after the
            # fact — op state and the _stopped latch change atomically
            reason = None
            with self._lock:
                if self._stopped:
                    return
                if (self._budget_deadline is not None
                        and now > self._budget_deadline):
                    reason = ("wall-clock budget exhausted"
                              + (f" during '{self._op}'" if self._op else ""))
                elif (self._op_deadline is not None
                        and now > self._op_deadline):
                    reason = (f"operation '{self._op}' exceeded its "
                              f"{self._op_timeout_s:g}s deadline")
                if reason is not None:
                    self._stopped = True
            if reason is not None:
                try:
                    self._on_expire(reason)
                finally:
                    self._exit_fn(self._exit_code)
