"""Wedge detection and bounded re-probing (``distmlip_tpu/utils/health.py``).

Two consumers, one implementation:

- a benchmark driver probes a risky resource with a disposable canary
  subprocess before claiming it in-process (:class:`CanaryProber`). A
  canary that neither exits nor fails within budget means the resource is
  wedged: the canary's process group is killed (TERM, grace, KILL) and ONE
  bounded re-probe with backoff runs before the resource is declared
  unavailable. The budgets come from :meth:`ProbeConfig.from_env`
  (``BENCH_CLAIM_TIMEOUT_S``, ``BENCH_RETRIES``, ``BENCH_RETRY_BACKOFF_S``,
  ``BENCH_WEDGE_REPROBES``, ``BENCH_WEDGE_REPROBE_TIMEOUT_S``,
  ``BENCH_CANARY_KILL_GRACE_S``), the same knobs and defaults as the JAX
  package's.
- the serving fleet (:mod:`distmlip_tpu_torch.fleet`) watches its live
  replicas with the same suspicion discipline through
  :class:`ReprobePolicy`: a failed heartbeat marks a replica SUSPECT, and
  bounded re-probes with backoff either clear the suspicion or confirm the
  wedge.

Host-only: nothing here touches the device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field


def kill_process_group(proc, grace_s: float | None = None) -> None:
    """TERM -> grace -> KILL a subprocess's whole process group.

    The target must run in its own session (``start_new_session=True``),
    so its pgid == its pid and any children it spawned die with it.
    Escalates to SIGKILL after ``grace_s`` (default: env
    ``BENCH_CANARY_KILL_GRACE_S``, 10 s) and always reaps the subprocess
    handle so no zombie outlives the caller."""
    import signal

    if grace_s is None:
        grace_s = float(os.environ.get("BENCH_CANARY_KILL_GRACE_S", "10"))
    try:
        pgid = os.getpgid(proc.pid)
    except (ProcessLookupError, PermissionError):
        proc.poll()
        return
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 5.0)):
        try:
            os.killpg(pgid, sig)
        except (ProcessLookupError, PermissionError):
            break
        try:
            proc.wait(timeout=wait_s)
            break
        except subprocess.TimeoutExpired:
            continue
    proc.poll()  # reap


@dataclass
class ProbeConfig:
    """Budgets of one canary-probe campaign (the bench's env knobs)."""

    claim_budget_s: float = 420.0
    retries: int = 3
    backoff_s: float = 30.0
    max_reprobes: int = 1
    reprobe_budget_s: float = 120.0
    poll_s: float = 2.0

    @classmethod
    def from_env(cls) -> "ProbeConfig":
        """The bench's knob set, read at call time (tests set env late)."""
        return cls(
            claim_budget_s=float(
                os.environ.get("BENCH_CLAIM_TIMEOUT_S", "420")),
            retries=max(1, int(os.environ.get("BENCH_RETRIES", "3"))),
            backoff_s=float(os.environ.get("BENCH_RETRY_BACKOFF_S", "30")),
            max_reprobes=max(
                0, int(os.environ.get("BENCH_WEDGE_REPROBES", "1"))),
            reprobe_budget_s=float(
                os.environ.get("BENCH_WEDGE_REPROBE_TIMEOUT_S", "120")),
        )


class CanaryProber:
    """Probe a risky resource with a DISPOSABLE subprocess before claiming.

    The risky first claim happens in a canary subprocess: if it exits 0 the
    resource is healthy and the parent claims in-process; if it raises, the
    probe retries within budget and then fails with a structured detail; if
    it neither exits nor fails within the budget the resource is wedged and
    the canary is KILLED (process-group TERM, grace, KILL; reported as
    ``canary: killed``) rather than left holding its pending claim. Killing
    the disposable canary is safe because the parent never started a claim
    of its own, and can itself release the resource, so one bounded
    re-probe with backoff runs before the resource is declared unavailable.

    ``launch()`` must return a started ``subprocess.Popen`` (in its own
    session); ``telemetry`` is a dict updated in place with the keys
    ``probe_attempts``, ``canary``, ``wedge_suspected``,
    ``wedge_reprobes``, ``canary_elapsed_s``, ``canary_pid``; ``phase``
    (optional) re-arms a watchdog deadline; ``log_path`` is where the
    canary's output lands (its tail rides failure details).

    ``run()`` returns ``(ok: bool, detail: str)``. Never raises.
    """

    def __init__(self, launch, config: ProbeConfig | None = None,
                 telemetry: dict | None = None, phase=None,
                 log_path: str = ""):
        self.launch = launch
        self.config = config
        self.telemetry = telemetry if telemetry is not None else {}
        self.phase = phase or (lambda msg, budget_s: None)
        self.log_path = log_path

    def _log_tail(self, n: int = 400) -> str:
        if not self.log_path:
            return ""
        try:
            with open(self.log_path, "rb") as f:
                return f.read()[-n:].decode("utf-8", "replace")
        except OSError:
            return ""

    def run(self) -> tuple[bool, str]:
        cfg = self.config or ProbeConfig.from_env()
        tel = self.telemetry
        tel.setdefault("probe_attempts", 0)
        tel.setdefault("wedge_reprobes", 0)
        claim_budget = cfg.claim_budget_s
        t_end = time.monotonic() + claim_budget
        # backup only — the poll loop below enforces the budget without
        # hanging
        self.phase(
            f"canary claim phase overran {claim_budget + 60:.0f}s",
            claim_budget + 60)
        detail = "canary never launched"
        attempt = 0
        while attempt < cfg.retries:
            tel["probe_attempts"] += 1
            t0 = time.monotonic()
            proc = self.launch()
            while time.monotonic() < t_end:
                rc = proc.poll()
                if rc is not None:
                    break
                time.sleep(cfg.poll_s)
            elapsed = time.monotonic() - t0
            tel["canary_elapsed_s"] = round(elapsed, 1)
            rc = proc.poll()
            if rc is None:
                # Budget exhausted, canary still mid-claim: the resource
                # is wedged. Kill the disposable canary's process group
                # instead of leaking it.
                kill_process_group(proc)
                tel["canary"] = "killed"
                tel["wedge_suspected"] = True
                tel["canary_pid"] = proc.pid
                detail = (
                    f"canary claim still pending after {elapsed:.0f}s "
                    f"(resource wedged; canary pid {proc.pid} killed, "
                    f"log {self.log_path})")
                if tel["wedge_reprobes"] < cfg.max_reprobes:
                    # killing the stuck claimer can itself release the
                    # server-side lease — ONE bounded re-probe with backoff
                    # before declaring the backend unavailable, so a
                    # transient wedge does not cost the whole run. The
                    # re-probe gets its own (clamped) budget; a second
                    # wedge fails for good.
                    tel["wedge_reprobes"] += 1
                    reprobe_budget = min(cfg.reprobe_budget_s, claim_budget)
                    wait = min(cfg.backoff_s, max(claim_budget / 4.0, 1.0))
                    print(f"# {detail}; re-probing once in {wait:.0f}s "
                          f"(budget {reprobe_budget:.0f}s)", file=sys.stderr)
                    self.phase(
                        f"wedge re-probe overran "
                        f"{reprobe_budget + wait + 60:.0f}s",
                        reprobe_budget + wait + 60)
                    time.sleep(wait)
                    t_end = time.monotonic() + reprobe_budget
                    continue  # relaunch without consuming a regular retry
                return False, detail
            if rc == 0:
                tel["canary"] = "ok"
                return True, f"canary healthy in {elapsed:.0f}s"
            # canary raised (e.g. UNAVAILABLE fast-fail): retry in budget
            tel["canary"] = "unavailable"
            tail = self._log_tail()
            detail = (f"canary exited rc={rc} after {elapsed:.0f}s "
                      f"(attempt {attempt + 1}/{cfg.retries}): "
                      f"{tail.strip()[-200:]}")
            print(f"# {detail}", file=sys.stderr)
            attempt += 1
            wait = cfg.backoff_s * attempt
            # only launch a retry canary if the remaining budget could
            # actually see it through (scaled by how long this one took to
            # fail) — a canary launched into seconds of budget would be
            # misreported as left_running/wedged when the resource was
            # merely slow-failing
            need = max(60.0, 1.5 * elapsed)
            if attempt < cfg.retries and \
                    time.monotonic() + wait + need < t_end:
                time.sleep(wait)
            else:
                break  # out of claim budget; fail structured, don't hang
        return False, detail


@dataclass
class ReprobePolicy:
    """Bounded suspicion-then-confirm discipline for a LIVE resource.

    The in-process analogue of the canary's kill-then-reprobe shape: a
    failed probe marks the resource SUSPECT rather than dead; the policy
    then requires ``max_reprobes`` FURTHER consecutive failures, each at
    least ``backoff_s`` apart (backing off between looks instead of
    hammering a struggling replica), before confirming the wedge. Any
    successful probe clears the suspicion entirely.

    Drive it with :meth:`observe`; it returns ``"healthy"``,
    ``"suspect"`` or ``"wedged"``. ``clock`` is injectable so tests step
    time deterministically.
    """

    max_reprobes: int = 1
    backoff_s: float = 1.0
    clock: object = time.monotonic

    failures: int = field(default=0, init=False)
    _last_look: float = field(default=float("-inf"), init=False)

    def observe(self, healthy: bool) -> str:
        now = self.clock()
        if healthy:
            self.failures = 0
            self._last_look = now
            return "healthy"
        if self.failures > 0 and now - self._last_look < self.backoff_s:
            # inside the backoff window: the previous verdict stands —
            # a rapid poll loop must not burn re-probes faster than the
            # resource could plausibly recover
            return "suspect" if self.failures <= self.max_reprobes \
                else "wedged"
        self.failures += 1
        self._last_look = now
        return "suspect" if self.failures <= self.max_reprobes else "wedged"

    def reset(self) -> None:
        self.failures = 0
        self._last_look = float("-inf")
