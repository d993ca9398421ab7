"""Heartbeat-supervised child processes for long-running harnesses.

Port of ``vectordb_tpu/utils/supervised.py``, a copy: it is
backend-neutral (processes, files and signals; no tensors). A harness
that can hang forever is worse than one that retries, and a supervisor
with one fixed watchdog kills its own healthy long phases, so:

- **Phase-declared budgets**: the heartbeat file's *content* carries the
  current phase's stale budget (written atomically via rename). A child
  entering a known-long operation (a cold build, a large load) declares
  ``hb.beat(budget=900)`` and the supervisor honors it; on phase exit the
  budget drops back to the default so true wedges in cheap phases die
  fast.
- **Escalation across attempts**: an ``escalate(attempt, env)`` hook
  mutates the child's environment per retry (longer watchdog, smaller
  shape) instead of re-running the failing config unchanged.
- **Partial-artifact capture**: with ``capture=True`` the supervisor
  collects the child's stdout even when it kills it, so a harness that
  emits its headline result line *early* cannot have a late wedge zero
  the artifact.

The startup grace compares the heartbeat file's mtime with the
supervisor's pre-spawn beat by equality, as the JAX package does
(ROADMAP queue 3): a child's first beat inside the same mtime tick is
not seen as a beat.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Heartbeat", "SuperviseResult", "supervise"]

HB_ENV = "VDB_BENCH_HB"


class Heartbeat:
    """Child-side heartbeat: touch a file the supervisor watches.

    ``beat(budget=None)`` refreshes the file's mtime; a non-None budget
    (seconds) is written as the file's content and raises the
    supervisor's staleness threshold until the next plain ``beat()``.
    Writes go through ``os.replace`` so the supervisor never reads a
    half-written budget.

    ``Heartbeat.from_env()`` returns a no-op instance when the process
    is not supervised (env var unset), so library code can beat
    unconditionally.
    """

    def __init__(self, path: Optional[str]):
        self.path = str(path) if path else None
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)

    @classmethod
    def from_env(cls, var: str = HB_ENV) -> "Heartbeat":
        return cls(os.environ.get(var))

    def beat(self, budget: Optional[float] = None) -> None:
        if not self.path:
            return
        try:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                if budget is not None:
                    f.write(f"{float(budget):.0f}")
            os.replace(tmp, self.path)
        except OSError:
            pass  # a missed beat must never crash the harness

    @contextmanager
    def phase(self, budget: float):
        """Declare a long phase: supervisor allows ``budget`` seconds of
        silence while inside; the default watchdog resumes on exit."""
        self.beat(budget=budget)
        try:
            yield self
        finally:
            self.beat()


def _declared_budget(hb_path: str, default: float) -> float:
    """Read the child's phase-declared budget from the heartbeat file
    content; the default applies when the file is empty/unreadable.
    A declared budget can only RAISE the threshold — a child cannot
    lower it below the supervisor's own default."""
    try:
        with open(hb_path) as f:
            txt = f.read().strip()
        return max(default, float(txt)) if txt else default
    except (OSError, ValueError):
        return default


@dataclass
class SuperviseResult:
    rc: int
    attempts: int
    stdout: str = ""                      # last attempt's captured stdout
    all_stdout: List[str] = field(default_factory=list)  # per attempt
    killed_stale: int = 0                 # watchdog kills across attempts


def supervise(
    argv: Sequence[str],
    *,
    hb_path: str,
    env: Optional[Dict[str, str]] = None,
    watchdog: float = 420.0,
    attempts: int = 3,
    poll: float = 15.0,
    escalate: Optional[Callable[[int, Dict[str, str]], None]] = None,
    capture: bool = False,
    restart_rc: Optional[int] = None,
    backoff: Callable[[int], float] = lambda a: min(30.0 * (a + 1), 180.0),
    success: Optional[Callable[[int, str], bool]] = None,
    startup_grace: Optional[float] = None,
    log=None,
) -> SuperviseResult:
    """Run ``argv`` as a child under a heartbeat watchdog; retry on
    wedge/crash.

    The child learns the heartbeat path from ``env[HB_ENV]`` (set here)
    and must beat it (see :class:`Heartbeat`); silence longer than the
    current threshold — ``max(watchdog, budget declared in the file)`` —
    gets the child killed *by exact pid* (never by pattern) and the
    attempt retried.

    - ``escalate(attempt, env)`` may mutate the env before each attempt
      (attempt is 0-based); use it to raise ``watchdog`` via the env or
      shrink the workload on late attempts.
    - ``restart_rc``: a child exit code meaning "planned restart" (e.g.
      clean-address-space handoff after a heavy phase): re-spawn with no
      backoff and without consuming an attempt.
    - ``success(rc, stdout)``: custom completion predicate; default is
      ``rc == 0``. With ``capture=True`` a harness can accept a killed
      child whose stdout already carries the result line.
    - ``startup_grace``: staleness allowance until the child's FIRST
      beat (detected as the heartbeat file's mtime moving past the
      supervisor's own pre-spawn beat). Interpreter start on a loaded
      single core measures >5 s here; killing a child mid-startup is a
      deterministic retry-of-the-same-failure. Defaults to
      ``max(watchdog, 30 s)``; a child that never beats at all is
      killed at ``max(limit, grace)``.
    """
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    base_env = dict(os.environ if env is None else env)
    base_env[HB_ENV] = hb_path
    result = SuperviseResult(rc=1, attempts=0)
    ok = success or (lambda rc, out: rc == 0)
    import inspect
    esc_takes_result = False
    if escalate is not None:
        try:
            esc_takes_result = len(
                inspect.signature(escalate).parameters) >= 3
        except (TypeError, ValueError):
            pass
    attempt = 0
    restarts = 0
    while attempt < attempts:
        cur_env = dict(base_env)
        if escalate is not None:
            # a 3-arg escalate also sees the partial result so far (the
            # per-attempt stdout), letting it pick a retry strategy based
            # on how far earlier attempts got
            if esc_takes_result:
                escalate(attempt, cur_env, result)
            else:
                escalate(attempt, cur_env)
        cur_watchdog = float(cur_env.get("VDB_SUPERVISE_WATCHDOG",
                                         watchdog))
        grace = (startup_grace if startup_grace is not None
                 else max(cur_watchdog, 30.0))
        Heartbeat(hb_path).beat()
        try:
            spawn_mark = os.path.getmtime(hb_path)
        except OSError:
            spawn_mark = None
        proc = subprocess.Popen(
            list(argv), env=cur_env,
            stdout=subprocess.PIPE if capture else None,
            text=capture)
        rc: Optional[int] = None
        stale_killed = False
        while rc is None:
            try:
                rc = proc.wait(timeout=poll)
            except subprocess.TimeoutExpired:
                try:
                    mtime = os.path.getmtime(hb_path)
                    age = time.time() - mtime
                except OSError:
                    mtime, age = None, 0.0
                limit = _declared_budget(hb_path, cur_watchdog)
                if spawn_mark is not None and mtime == spawn_mark:
                    # the child has not beaten yet: allow startup_grace
                    # (interpreter start under load is not a wedge)
                    limit = max(limit, grace)
                if age > limit:
                    log(f"[supervise] heartbeat stale {age:.0f}s "
                        f"(limit {limit:.0f}s): killing pid {proc.pid} "
                        f"(attempt {attempt + 1}/{attempts})")
                    try:
                        os.kill(proc.pid, signal.SIGKILL)
                    except OSError:
                        pass
                    rc = proc.wait()
                    stale_killed = True
        out = proc.stdout.read() if capture and proc.stdout else ""
        if capture:
            result.all_stdout.append(out)
            result.stdout = out
        if stale_killed:
            result.killed_stale += 1
        result.attempts = attempt + 1
        if ok(rc, out):
            result.rc = 0
            return result
        if restart_rc is not None and rc == restart_rc and restarts < 64:
            restarts += 1
            log(f"[supervise] child requested restart "
                f"({restarts} so far)")
            continue
        attempt += 1
        if attempt < attempts:
            log(f"[supervise] attempt {attempt}/{attempts} failed "
                f"(rc={rc}); backing off")
            time.sleep(backoff(attempt - 1))
    result.rc = 1
    return result
