"""The port's heartbeat supervisor (utils/supervised.py) against the JAX
package's.

Mirrors tests/test_supervised.py case by case: the stale kill, the
phase budget, escalation, partial-artifact capture and the restart code.
The module is a copy (it touches processes, files and signals, no
tensors): the in-process cases run on both packages' modules, the
subprocess cases on the port's, whose children load the module file by
path (no package import, so no torch start-up under the watchdog). No
case depends on the startup grace's mtime-equality test (ROADMAP queue
3): a child that must end its grace sleeps seconds past any beat.
"""

from __future__ import annotations

import inspect
import sys
import textwrap

import pytest

import vectordb_tpu.utils.supervised as jsup
import vectordb_tpu_torch.utils.supervised as tsup
from vectordb_tpu_torch.utils.supervised import (HB_ENV, Heartbeat,
                                                 SuperviseResult, supervise)

MODS = [pytest.param(jsup, id="jax"), pytest.param(tsup, id="port")]
_LOAD = (f"import importlib.util as u, sys\n"
         f"s = u.spec_from_file_location('sup', {tsup.__file__!r})\n"
         f"sup = sys.modules['sup'] = u.module_from_spec(s)\n"
         f"s.loader.exec_module(sup)\n")


def _child(tmp_path, body: str) -> list:
    p = tmp_path / "child.py"
    p.write_text(_LOAD + textwrap.dedent(body))
    return [sys.executable, str(p)]


def _fast(**kw):
    # a 5 s default watchdog: a sleep(60) wedge dies fast, and a child's
    # interpreter start on a loaded core is not killed mid-start. Cases
    # that need a first-attempt kill of a briefly silent child pass
    # watchdog=1.0 and stay silent long past any start latency.
    kw.setdefault("watchdog", 5.0)
    kw.setdefault("poll", 0.2)
    kw.setdefault("backoff", lambda a: 0.0)
    return kw


def test_the_port_is_the_jax_packages_code():
    """Everything below the docstring is the JAX package's code."""
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__ import annotations"):]
    assert body(tsup) == body(jsup)
    assert tsup.__all__ == jsup.__all__ and tsup.HB_ENV == jsup.HB_ENV


class TestHeartbeat:
    @pytest.mark.parametrize("mod", MODS)
    def test_noop_when_unsupervised(self, monkeypatch, mod):
        monkeypatch.delenv(mod.HB_ENV, raising=False)
        hb = mod.Heartbeat.from_env()
        assert hb.path is None
        hb.beat()                      # must not raise
        with hb.phase(100):
            hb.beat(budget=5)

    @pytest.mark.parametrize("mod", MODS)
    def test_beat_writes_budget_content(self, tmp_path, mod):
        p = tmp_path / "hb"
        hb = mod.Heartbeat(str(p))
        hb.beat()
        assert p.read_text() == ""
        hb.beat(budget=900)
        assert p.read_text() == "900"
        hb.beat()
        assert p.read_text() == ""

    @pytest.mark.parametrize("mod", MODS)
    def test_phase_restores_default(self, tmp_path, mod):
        p = tmp_path / "hb"
        hb = mod.Heartbeat(str(p))
        with hb.phase(300):
            assert p.read_text() == "300"
        assert p.read_text() == ""

    @pytest.mark.parametrize("mod", MODS)
    def test_phase_restores_on_exception(self, tmp_path, mod):
        p = tmp_path / "hb"
        hb = mod.Heartbeat(str(p))
        with pytest.raises(RuntimeError):
            with hb.phase(300):
                raise RuntimeError("boom")
        assert p.read_text() == ""


class TestSupervise:
    def test_healthy_child_passes_through(self, tmp_path):
        argv = _child(tmp_path, """
            sup.Heartbeat.from_env().beat()
            print("hello")
        """)
        res = supervise(argv, hb_path=str(tmp_path / "hb"),
                        capture=True, **_fast(watchdog=30.0))
        assert res.rc == 0
        assert res.attempts == 1
        assert "hello" in res.stdout

    def test_wedged_child_killed_and_retried(self, tmp_path):
        # the child never beats: every attempt dies to the watchdog
        # (startup_grace=1 for fast kills)
        argv = _child(tmp_path, """
            import time
            time.sleep(60)
        """)
        res = supervise(argv, hb_path=str(tmp_path / "hb"),
                        attempts=2, startup_grace=1.0, **_fast())
        assert res.rc == 1
        assert res.attempts == 2
        assert res.killed_stale == 2

    def test_phase_budget_prevents_kill(self, tmp_path):
        # a declared 60 s budget, then 8 s of silence past the 5 s
        # watchdog: the child survives and completes
        argv = _child(tmp_path, """
            import time
            hb = sup.Heartbeat.from_env()
            with hb.phase(60):
                time.sleep(8)
            print("done")
        """)
        res = supervise(argv, hb_path=str(tmp_path / "hb"),
                        capture=True, **_fast())
        assert res.rc == 0
        assert res.killed_stale == 0
        assert "done" in res.stdout

    @pytest.mark.parametrize("mod", MODS)
    def test_budget_cannot_lower_watchdog(self, tmp_path, mod):
        assert mod.Heartbeat(str(tmp_path / "x")) is not None
        p = tmp_path / "hb"
        p.write_text("1")             # child declares 1 s
        assert mod._declared_budget(str(p), 420.0) == 420.0
        p.write_text("900")
        assert mod._declared_budget(str(p), 420.0) == 900.0
        p.write_text("garbage")
        assert mod._declared_budget(str(p), 420.0) == 420.0
        assert mod._declared_budget(str(tmp_path / "none"), 7.0) == 7.0

    def test_escalation_env_reaches_child(self, tmp_path):
        # attempt 0 fails (knob unset); escalate sets it; attempt 1 passes
        argv = _child(tmp_path, """
            import os, sys
            sys.exit(0 if os.environ.get("KNOB") == "on" else 7)
        """)
        seen = []

        def escalate(attempt, env):
            seen.append(attempt)
            if attempt >= 1:
                env["KNOB"] = "on"

        res = supervise(argv, hb_path=str(tmp_path / "hb"),
                        attempts=3, escalate=escalate,
                        **_fast(watchdog=30.0))
        assert res.rc == 0
        assert res.attempts == 2
        assert seen == [0, 1]

    def test_escalated_watchdog_env(self, tmp_path):
        # VDB_SUPERVISE_WATCHDOG in the escalated env raises the
        # supervisor's threshold for that attempt: 8 s of silence dies at
        # attempt 1's 1 s and survives attempt 2's 60 s
        argv = _child(tmp_path, """
            import time
            time.sleep(8)
            print("survived")
        """)

        def escalate(attempt, env):
            if attempt >= 1:
                env["VDB_SUPERVISE_WATCHDOG"] = "60"

        res = supervise(argv, hb_path=str(tmp_path / "hb"), attempts=2,
                        escalate=escalate, capture=True,
                        startup_grace=1.0, **_fast(watchdog=1.0))
        assert res.rc == 0
        assert res.attempts == 2
        assert res.killed_stale == 1
        assert "survived" in res.stdout

    def test_partial_artifact_capture(self, tmp_path):
        # the result line comes first, then a wedge: the success
        # predicate accepts the kill because the line exists
        argv = _child(tmp_path, """
            import time
            print('{"metric": "x", "value": 1}', flush=True)
            sup.Heartbeat.from_env().beat()   # ends the startup grace
            time.sleep(60)                    # ... then wedges
        """)
        res = supervise(
            argv, hb_path=str(tmp_path / "hb"), attempts=1,
            capture=True,
            success=lambda rc, out: any(
                ln.startswith("{") for ln in out.splitlines()),
            startup_grace=1.0, **_fast())
        assert res.rc == 0
        assert res.killed_stale == 1
        assert '"metric": "x"' in res.stdout

    def test_restart_rc_not_counted(self, tmp_path):
        # rc=3 = a planned restart: respawn without consuming an attempt
        marker = tmp_path / "count"
        argv = _child(tmp_path, """
            import sys
            from pathlib import Path
            m = Path(%r)
            n = int(m.read_text()) if m.exists() else 0
            m.write_text(str(n + 1))
            sys.exit(3 if n < 2 else 0)
        """ % str(marker))
        res = supervise(argv, hb_path=str(tmp_path / "hb"),
                        attempts=1, restart_rc=3,
                        **_fast(watchdog=30.0))
        assert res.rc == 0
        assert res.attempts == 1
        assert marker.read_text() == "3"


class TestBenchSupervisorWiring:
    """A driver reads the LAST JSON line any attempt produced (a full
    line supersedes an early headline)."""

    @pytest.mark.parametrize("mod", MODS)
    def test_bench_partial_line_logic(self, mod):
        res = mod.SuperviseResult(rc=0, attempts=2, all_stdout=[
            "",                                        # attempt 1: wedged
            '{"value": 1}\n{"value": 2, "full": true}\n',
        ])
        line = None
        for out in res.all_stdout:
            for ln in out.splitlines():
                if ln.startswith("{"):
                    line = ln
        assert line == '{"value": 2, "full": true}'
        assert res.stdout == "" and res.killed_stale == 0


def test_supervised_child_sees_the_heartbeat_env(tmp_path):
    """The child learns the heartbeat path from HB_ENV; the port's and
    the JAX package's names agree."""
    argv = _child(tmp_path, """
        import os
        print(os.environ[sup.HB_ENV])
    """)
    res = supervise(argv, hb_path=str(tmp_path / "hb"), capture=True,
                    **_fast(watchdog=30.0))
    assert res.rc == 0 and res.stdout.strip() == str(tmp_path / "hb")
    assert HB_ENV == jsup.HB_ENV == "VDB_BENCH_HB"
    assert isinstance(res, SuperviseResult)
    assert Heartbeat(None).path is None
