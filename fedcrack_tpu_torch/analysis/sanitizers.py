"""The lock factory of the port, and the lock-order monitor behind it.

The counterpart of ``make_lock``, :class:`LockOrderMonitor`,
:func:`install_monitor` and :func:`uninstall_monitor` in
``fedcrack_tpu.analysis.sanitizers``. Locks built through
``make_lock(name)`` are plain ``threading.Lock`` objects unless a monitor
is installed; with one installed (tests install it explicitly; there is no
environment switch), every acquisition records the per-thread stack of
held lock names, and acquiring A while holding B after B was ever taken
while holding A raises :class:`LockOrderViolation` with both acquisition
stacks, before blocking, so a latent deadlock fails loudly even when the
timing never deadlocks.

The serving fleet nests locks: the router's dispatch lock
(``serve.router.dispatch``) is held while ``_pick`` reads each batcher's
``outstanding()`` under ``serve.batcher.stats``. The jit-cache and
transfer-guard sanitizers of the JAX module are JAX's and have no part here.
"""

from __future__ import annotations

import threading
import traceback


class LockOrderViolation(RuntimeError):
    """Two locks were acquired in both orders: a latent deadlock."""


class LockOrderMonitor:
    """Records lock-acquisition order edges with stacks; raises on inversion.

    The check runs BEFORE blocking on the real lock, so a would-be deadlock
    surfaces as an exception with both stacks instead of a hang.
    """

    def __init__(self) -> None:
        self._held = threading.local()
        self._edges: dict[tuple[str, str], str] = {}
        self._edge_lock = threading.Lock()

    def _stack(self) -> list[str]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def on_acquire(self, name: str) -> None:
        held = self._stack()
        if not held:
            # A leaf acquisition records no edge: skip the stack capture.
            held.append(name)
            return
        stack_txt = "".join(traceback.format_stack(limit=12))
        for h in held:
            if h == name:
                continue
            edge, rev = (h, name), (name, h)
            with self._edge_lock:
                if rev in self._edges and edge not in self._edges:
                    raise LockOrderViolation(
                        f"lock order inversion: acquiring {name!r} while "
                        f"holding {h!r}, but the opposite order was recorded "
                        f"earlier.\n--- this acquisition ---\n{stack_txt}"
                        f"--- earlier {rev[0]!r}->{rev[1]!r} ---\n"
                        f"{self._edges[rev]}"
                    )
                self._edges.setdefault(edge, stack_txt)
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def edges(self) -> set[tuple[str, str]]:
        with self._edge_lock:
            return set(self._edges)


class _MonitoredLock:
    """``threading.Lock`` plus order recording: the context manager,
    ``acquire``/``release`` and ``locked``."""

    def __init__(self, name: str, monitor: LockOrderMonitor):
        self._name = name
        self._monitor = monitor
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._monitor.on_acquire(self._name)
        got = self._lock.acquire(blocking, timeout)
        if not got:
            self._monitor.on_release(self._name)
        return got

    def release(self) -> None:
        self._lock.release()
        self._monitor.on_release(self._name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


_monitor: LockOrderMonitor | None = None
_monitor_lock = threading.Lock()


def install_monitor() -> LockOrderMonitor:
    """Turn on lock-order monitoring for locks created AFTER this call."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = LockOrderMonitor()
        return _monitor


def uninstall_monitor() -> None:
    global _monitor
    with _monitor_lock:
        _monitor = None


def make_lock(name: str):
    """A plain ``threading.Lock`` unless a monitor is installed, in which
    case the lock records its acquisition order under ``name``. With no
    monitor the cost is one module-global read at construction."""
    mon = _monitor
    if mon is None:
        return threading.Lock()
    return _MonitoredLock(name, mon)
