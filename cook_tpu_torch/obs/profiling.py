"""Device profile capture: single-flight, duration-bounded, rate-limited.

Port of `cook_tpu/obs/profiling.py` with `torch.profiler` in place of
`jax.profiler.start_trace` / `stop_trace`: a capture records CUDA
activity (kernels, copies, runtime calls) where a card is present, and
host activity, and writes a chrome trace (`TRACE_FILE`, Perfetto-
loadable) into the capture's directory.  Raw profiler access is
operationally dangerous on a live scheduler: two concurrent captures
corrupt each other (the profiler is process-global), an unmatched start
leaks collection overhead forever, and an automatic trigger that fires
on every degraded health probe would profile continuously exactly when
the system is slowest.

`ProfileCapturer` makes capture safe to expose:

  * **single-flight** — at most one capture in flight per capturer (and
    `_torch_start` refuses a second open capture in the process); a
    second request is rejected with the active capture's identity
    instead of corrupting it;
  * **duration-bounded** — every capture stops itself on a daemon timer
    (clamped to `max_duration_s`), so a capture nobody stops cannot
    leave the profiler on;
  * **cooldown-rate-limited auto capture** — `maybe_capture_auto` fires
    only for latency-shaped health reasons (`AUTO_PROFILE_REASONS`) and
    at most once per `cooldown_s`, so a flapping verdict cannot turn the
    leader into a full-time profiler.

`torch.profiler` keeps its session in thread-local state, while the
capture starts on the caller's thread and stops on the timer's: each
capture therefore runs its profiler on a thread of its own, which starts
it, waits for the stop and exports the trace.  The CUDA activity (CUPTI)
is process-wide, so the trace holds the kernels every thread launched;
host operator events are only the capture thread's own.

The start/stop functions are injectable so tests exercise the lifecycle
without the real profiler.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry

# health reasons that mean "latency went somewhere the host cannot see":
# worth a device profile.  Deliberately DEVICE-shaped only —
# commit-ack-slo-burn is a control-plane overload where a device profile
# holds little of the answer (the bundle's contention snapshot does) and
# the capture's own overhead measurably worsens the burn on a saturated
# leader (verified: a 3 s auto capture during an SLO burn pushed sync-ack
# replication past its bound) — an incident tool must not amplify the
# incident it is documenting.
AUTO_PROFILE_REASONS = frozenset({
    "solve-latency-regression",
    "device-degraded",
})


# the chrome trace each capture writes into its directory
TRACE_FILE = "device_trace.json"

_session_lock = threading.Lock()
_session: Optional[tuple] = None  # (thread, stop event, outcome box)


def _torch_start(log_dir: str) -> None:
    """Open the process's one `torch.profiler` capture (CPU activity, and
    CUDA where a card is present) on a capture thread; raises if one is
    already open or the profiler fails to start."""
    global _session
    with _session_lock:
        if _session is not None:
            raise RuntimeError("a torch.profiler capture is already open "
                               "in this process")
        started, stop, box = threading.Event(), threading.Event(), {}

        def run() -> None:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            try:
                prof.start()
            except BaseException as e:  # noqa: BLE001 — reported below
                box["error"] = e
                started.set()
                return
            started.set()
            stop.wait()
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
            except BaseException as e:  # noqa: BLE001 — reported at stop
                box["error"] = e

        thread = threading.Thread(target=run, name="profile-capture",
                                  daemon=True)
        thread.start()
        started.wait()
        if "error" in box:
            thread.join()
            raise RuntimeError(f"torch.profiler did not start: "
                               f"{box['error']}")
        _session = (thread, stop, box)


def _torch_stop() -> None:
    """Close the open capture: stop the profiler, write the trace, and
    re-raise whatever failed on the capture thread."""
    global _session
    with _session_lock:
        session, _session = _session, None
    if session is None:
        return
    thread, stop, box = session
    stop.set()
    thread.join()
    if "error" in box:
        raise RuntimeError(f"torch.profiler stop/export failed: "
                           f"{box['error']}")


class ProfileCapturer:
    def __init__(self, *, base_dir: Optional[str] = None,
                 default_duration_s: float = 3.0,
                 max_duration_s: float = 30.0,
                 cooldown_s: float = 300.0,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None,
                 history: int = 8):
        import tempfile

        self.base_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "cook-tpu-torch-profiles")
        self.default_duration_s = default_duration_s
        self.max_duration_s = max_duration_s
        self.cooldown_s = cooldown_s
        self._start = start_fn or _torch_start
        self._stop = stop_fn or _torch_stop
        self._lock = threading.Lock()
        self._active: Optional[dict] = None
        self._last_auto: float = float("-inf")
        self._seq = 0
        self._history: deque = deque(maxlen=history)
        self._captures = global_registry.counter(
            "profile.captures",
            "device profile captures started, per trigger")
        self._rejected = global_registry.counter(
            "profile.rejected",
            "profile capture requests rejected, per cause "
            "(in-flight, cooldown, profiler-error)")
        self._active_gauge = global_registry.gauge(
            "profile.active", "1 while a device profile capture is open")

    # ------------------------------------------------------------- capture

    def capture(self, duration_s: Optional[float] = None, *,
                trigger: str = "manual") -> dict:
        """Start one bounded capture.  Returns the capture descriptor
        ({"started": True, "log_dir": ..., ...}) or a rejection
        ({"started": False, "reason": ...}) — never raises."""
        duration = min(float(duration_s or self.default_duration_s),
                       self.max_duration_s)
        if duration <= 0:
            return {"started": False, "reason": "non-positive duration"}
        # reserve the single-flight slot under the lock, but run the
        # (potentially slow) profiler start OUTSIDE it: GET /debug/profile
        # and concurrent capture attempts must not block on profiler work
        with self._lock:
            if self._active is not None:
                self._rejected.inc(1, {"cause": "in-flight"})
                return {"started": False, "reason": "capture-in-flight",
                        "active": dict(self._active)}
            self._seq += 1
            log_dir = os.path.join(
                self.base_dir, f"profile-{self._seq:04d}")
            entry = {"seq": self._seq, "trigger": trigger,
                     "log_dir": log_dir, "duration_s": duration,
                     "wall_time": time.time(), "completed": False}
            self._active = entry
        try:
            os.makedirs(log_dir, exist_ok=True)
            self._start(log_dir)
        except Exception as e:  # noqa: BLE001 — a wedged profiler must
            # degrade to "no profile", never break the caller (the
            # health probe / incident capture path runs this)
            with self._lock:
                self._active = None
            self._rejected.inc(1, {"cause": "profiler-error"})
            return {"started": False, "reason": f"profiler-error: {e}"}
        self._active_gauge.set(1.0)
        self._captures.inc(1, {"trigger": trigger})
        timer = threading.Timer(duration, self._finish)
        timer.daemon = True
        timer.start()
        return {"started": True, **entry}

    def _finish(self) -> None:
        # stop BEFORE releasing the slot — if _active were cleared first,
        # a capture starting in the gap would have its fresh trace
        # killed by this (stale) timer — but run the (slow, profile-
        # serializing) stop outside the lock: the still-occupied slot is
        # what serializes the profiler, the lock only guards the fields
        with self._lock:
            entry = self._active
        if entry is None:
            return
        try:
            self._stop()
        except Exception:  # noqa: BLE001 — stop failing must not kill
            # the timer thread; the next start attempt will surface it
            self._rejected.inc(1, {"cause": "profiler-error"})
        with self._lock:
            entry["completed"] = True
            self._history.append(dict(entry))
            self._active = None
        self._active_gauge.set(0.0)

    def maybe_capture_auto(self, reasons) -> dict:
        """Automatic capture for a degraded health verdict: fires only on
        latency-shaped reasons, at most once per cooldown.  The cooldown
        is only committed when a capture actually STARTS — a rejection
        (slot in flight, profiler error) must not block the auto profile
        for the whole next window."""
        latency = sorted(set(reasons) & AUTO_PROFILE_REASONS)
        if not latency:
            return {"started": False, "reason": "no-latency-shaped-reason"}
        with self._lock:
            if time.monotonic() - self._last_auto < self.cooldown_s:
                self._rejected.inc(1, {"cause": "cooldown"})
                return {"started": False, "reason": "cooldown",
                        "cooldown_s": self.cooldown_s}
        result = self.capture(trigger="auto:" + ",".join(latency))
        if result.get("started"):
            with self._lock:
                self._last_auto = time.monotonic()
        return result

    # --------------------------------------------------------------- reads

    def status(self) -> dict:
        with self._lock:
            return {
                "active": dict(self._active) if self._active else None,
                "recent": [dict(e) for e in self._history],
                "base_dir": self.base_dir,
                "default_duration_s": self.default_duration_s,
                "max_duration_s": self.max_duration_s,
                "auto_cooldown_s": self.cooldown_s,
            }
