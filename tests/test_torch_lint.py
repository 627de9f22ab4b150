"""reflow-lint for the port (``reflow_tpu_torch.analysis``): a counterpart
of every test of ``tests/test_lint.py`` with its fixture trees under
``reflow_tpu_torch/`` (and the port's tests named
``tests/test_torch_*.py``), the runtime monitor's tests against the
port's ``utils/runtime.py``, parity with the JAX passes fixture by
fixture, the port's scope, its CLI, the real tree held to no finding,
and a small lockcheck run in a child process.

Fixture corpora are tiny repos written under tmp_path. Each fixture is
a template whose ``{P}`` is the package directory, so the same tree can
be laid out under ``reflow_tpu/`` for the JAX passes and under
``reflow_tpu_torch/`` for the port's.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from reflow_tpu.analysis import run as jax_run
from reflow_tpu.analysis.core import RULES as JAX_RULES
from reflow_tpu_torch.analysis import import_passes, run
from reflow_tpu_torch.analysis.core import RULES
from reflow_tpu_torch.analysis.seams import _seam_literals
from reflow_tpu_torch.utils.config import KNOBS, declare, knob_table
from reflow_tpu_torch.utils.runtime import (LockOrderError,
                                            LockOrderMonitor, NamedLock,
                                            named_lock)

ROOT = Path(__file__).resolve().parent.parent
PORT = "reflow_tpu_torch"
JAX = "reflow_tpu"

# -- fixtures: name -> ({path: text}, run kwargs); "{P}" is the package --

FIXTURES = {
    "lock_unnamed_bad": ({"{P}/m.py": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n")}, {"passes": ["locks"]}),
    "lock_unnamed_ok": ({"{P}/m.py": (
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('m.c')\n")}, {"passes": ["locks"]}),
    "lock_cycle_bad": ({"{P}/m.py": (
        "from {P}.utils.runtime import named_lock\n"
        "A = named_lock('a')\n"
        "B = named_lock('b')\n"
        "def fwd():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def rev():\n"
        "    with B:\n"
        "        with A:\n"
        "            pass\n")}, {"passes": ["locks"]}),
    "lock_cycle_ok": ({"{P}/m.py": (
        "from {P}.utils.runtime import named_lock\n"
        "A = named_lock('a')\n"
        "B = named_lock('b')\n"
        "def fwd():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def fwd2():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n")}, {"passes": ["locks"]}),
    "lock_cycle_expansion": ({"{P}/m.py": (
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._a = named_lock('a')\n"
        "        self._b = named_lock('b')\n"
        "    def helper(self):\n"
        "        with self._b:\n"
        "            pass\n"
        "    def m1(self):\n"
        "        with self._a:\n"
        "            self.helper()\n"
        "    def m2(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n")}, {"passes": ["locks"]}),
    "lock_blocking_bad": ({"{P}/m.py": (
        "import os\n"
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('m.c')\n"
        "    def f(self, fd):\n"
        "        with self._lock:\n"
        "            os.fsync(fd)\n")}, {"passes": ["locks"]}),
    "lock_blocking_waived": ({"{P}/m.py": (
        "import os\n"
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('m.c')\n"
        "    def f(self, fd):\n"
        "        with self._lock:\n"
        "            os.fsync(fd)"
        "  # reflow-lint: waive lock-blocking-call -- test\n")},
        {"passes": ["locks"]}),
    "lock_wait_bad": ({"{P}/m.py": (
        "import threading\n"
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('m.c')\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "    def f(self):\n"
        "        with self._cv:\n"
        "            self._cv.wait()\n")}, {"passes": ["locks"]}),
    "lock_wait_ok": ({"{P}/m.py": (
        "import threading\n"
        "from {P}.utils.runtime import named_lock\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = named_lock('m.c')\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "    def f(self):\n"
        "        with self._cv:\n"
        "            while self.pending:\n"
        "                self._cv.wait()\n")}, {"passes": ["locks"]}),
    "seam_grammar_bad": ({"{P}/m.py": (
        "class C:\n"
        "    def f(self):\n"
        "        self._crash.point('Bad-Seam')\n")}, {"passes": ["seams"]}),
    "seam_untested": ({
        "{P}/m.py": ("class C:\n"
                     "    def f(self):\n"
                     "        self._crash_point('lonely_seam')\n"),
        "tests/test_torch_x.py": "# nothing\n"}, {"passes": ["seams"]}),
    "seam_tested": ({
        "{P}/m.py": ("class C:\n"
                     "    def f(self):\n"
                     "        self._crash_point('lonely_seam')\n"),
        "tests/test_torch_x.py":
            "inj = CrashInjector(1, only='lonely_seam@g')\n"},
        {"passes": ["seams"]}),
    "seam_dynamic_ok": ({
        "{P}/m.py": ("class C:\n"
                     "    def f(self):\n"
                     "        self._crash.point(f'pool_x@{self.name}')\n"),
        "tests/test_torch_x.py": "only='pool_x@g0'\n"}, {"passes": ["seams"]}),
    "seam_dynamic_bad": ({"{P}/m.py": (
        "class C:\n"
        "    def f(self):\n"
        "        self._crash.point(f'POOLX-{self.name}')\n")},
        {"passes": ["seams"]}),
    "metrics_unpaired": ({"{P}/m.py": (
        "class C:\n"
        "    def publish(self, reg):\n"
        "        reg.register_source('c', lambda: {})\n")},
        {"passes": ["metrics"]}),
    "metrics_paired": ({"{P}/m.py": (
        "class C:\n"
        "    def publish(self, reg):\n"
        "        reg.register_source('c', lambda: {})\n"
        "    def close(self, reg):\n"
        "        reg.unregister_source('c')\n")}, {"passes": ["metrics"]}),
    "metrics_name_bad": ({"{P}/m.py": (
        "def p(reg):\n"
        "    reg.gauge('Bad-Name', lambda: 1)\n"
        "    reg.unregister_prefix('x.')\n")}, {"passes": ["metrics"]}),
    "metrics_name_ok": ({"{P}/m.py": (
        "def p(reg, key):\n"
        "    reg.gauge(f'{key}.fsync_rate', lambda: 1)\n"
        "    reg.unregister_prefix(f'{key}.')\n")}, {"passes": ["metrics"]}),
    "metrics_mismatch": ({"{P}/m.py": (
        "from {P}.obs import REGISTRY\n"
        "class C:\n"
        "    def publish(self, reg):\n"
        "        reg.gauge('c.depth', lambda: 1)\n"
        "    def close(self):\n"
        "        REGISTRY.unregister_prefix('c.')\n")},
        {"passes": ["metrics"]}),
    "metrics_pairs_ok": ({"{P}/m.py": (
        "class C:\n"
        "    def publish(self, reg):\n"
        "        reg.gauge('c.depth', lambda: 1)\n"
        "        self._pairs = [(reg, 'c.')]\n"
        "    def close(self):\n"
        "        for reg, name in self._pairs:\n"
        "            reg.unregister_prefix(name)\n")},
        {"passes": ["metrics"]}),
    "metrics_global_ok": ({"{P}/m.py": (
        "from {P}.obs import REGISTRY\n"
        "def publish():\n"
        "    REGISTRY.gauge('c.depth', lambda: 1)\n"
        "def close():\n"
        "    REGISTRY.unregister_prefix('c.')\n")}, {"passes": ["metrics"]}),
    "metrics_orphan": ({"bench_helper.py": (
        "def hook(reg):\n"
        "    reg.register_source('orphan.src', lambda: {})\n")},
        {"passes": ["metrics"]}),
    "metrics_orphan_released_elsewhere": ({
        "bench_helper.py": (
            "def hook(reg):\n"
            "    reg.register_source('orphan.src', lambda: {})\n"),
        "{P}/sealer.py": (
            "def seal(reg):\n"
            "    reg.unregister_prefix('orphan.')\n")},
        {"passes": ["metrics"]}),
    "metrics_orphan_released_here": ({"bench_helper.py": (
        "def hook(reg):\n"
        "    reg.register_source('orphan.src', lambda: {})\n"
        "def unhook(reg):\n"
        "    reg.unregister_source('orphan.src')\n")},
        {"passes": ["metrics"]}),
    "env_direct_bad": ({"{P}/m.py": (
        "import os\n"
        "x = os.environ.get('REFLOW_SOMETHING')\n")},
        {"passes": ["envknobs"], "rules": ["env-knob-direct"]}),
    "env_write_ok": ({"{P}/m.py": (
        "import os\n"
        "env = dict(os.environ)\n"
        "env['REFLOW_SOMETHING'] = '1'\n")},
        {"passes": ["envknobs"], "rules": ["env-knob-direct"]}),
    "env_undeclared": ({"{P}/m.py": (
        "from {P}.utils.config import env_int\n"
        "x = env_int('REFLOW_NEVER_DECLARED_XYZ')\n")},
        {"passes": ["envknobs"], "rules": ["env-knob-undeclared"]}),
    "env_declared": ({"{P}/m.py": (
        "from {P}.utils.config import env_int\n"
        "x = env_int('REFLOW_WINDOW_DEPTH')\n")},
        {"passes": ["envknobs"], "rules": ["env-knob-undeclared"]}),
    "env_undocumented": ({"docs/guide.md": "# nothing\n",
                          "README.md": "# nothing\n"},
                         {"passes": ["envknobs"],
                          "rules": ["env-knob-undocumented"]}),
    "bare_assert": ({"{P}/m.py": (
        "def f(x):\n"
        "    assert x is not None\n"
        "    return x\n")}, {"passes": ["exceptions"]}),
    "typed_raise": ({"{P}/m.py": (
        "def f(x):\n"
        "    if x is None:\n"
        "        raise ValueError('x required')\n"
        "    return x\n")}, {"passes": ["exceptions"]}),
    "assert_in_test": ({"tests/test_torch_m.py": "assert True\n"},
                       {"passes": ["exceptions"]}),
    # the marker is split so linting THIS file doesn't see a bad waiver
    "waiver_no_reason": ({"{P}/m.py": (
        "def f(x):\n"
        "    # reflow-lint: " + "waive bare-assert\n"
        "    assert x\n")}, {"passes": ["exceptions"]}),
    "waiver_reason": ({"{P}/m.py": (
        "def f(x):\n"
        "    # reflow-lint: waive bare-assert -- fixture says so\n"
        "    assert x\n")}, {"passes": ["exceptions"]}),
    "socket_naked": ({"{P}/m.py": (
        "import socket\n"
        "def pull(sock):\n"
        "    return sock.recv(4096)\n"
        "def dial(addr):\n"
        "    s = socket.socket()\n"
        "    s.connect(addr)\n"
        "    return s\n")}, {"passes": ["sockets"]}),
    "socket_deadline": ({"{P}/m.py": (
        "import socket\n"
        "def pull(sock, deadline_s):\n"
        "    sock.settimeout(deadline_s)\n"
        "    return sock.recv(4096)\n"
        "def dial(addr):\n"
        "    return socket.create_connection(addr, timeout=2.0)\n"
        "def dial_kw(conn, addr):\n"
        "    conn.connect(addr, timeout=2.0)\n")}, {"passes": ["sockets"]}),
    "socket_non_importer": ({"{P}/m.py": (
        "def wire(graph, a, b):\n"
        "    graph.connect(a, b)\n"
        "    return graph.accept()\n")}, {"passes": ["sockets"]}),
    "socket_waived": ({"{P}/m.py": (
        "import socket\n"
        "def wait_forever(sock):\n"
        "    # reflow-lint: waive socket-no-timeout -- fixture blocks\n"
        "    return sock.recv(1)\n")}, {"passes": ["sockets"]}),
    "pycache_skipped": ({"{P}/m.py": "x = 1\n",
                         "{P}/__pycache__/m.py": "assert False\n"},
                        {"passes": ["exceptions"]}),
}


def _write(root: Path, files, pkg: str) -> None:
    for rel, text in files.items():
        p = root / rel.replace("{P}", pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text.replace("{P}", pkg))


def _fixture(tmp_path: Path, name: str, pkg: str = PORT, runner=run):
    files, kw = FIXTURES[name]
    root = tmp_path / f"{name}-{pkg}"
    _write(root, files, pkg)
    return runner(str(root), **kw)


def _lint(root: Path, text_by_path, **kw):
    _write(root, text_by_path, PORT)
    return run(str(root), **kw)


def _rules(report):
    return sorted({f["rule"] for f in report["findings"]})


# -- lock rules -------------------------------------------------------------

def test_lock_unnamed_trips_and_named_is_clean(tmp_path):
    assert _rules(_fixture(tmp_path, "lock_unnamed_bad")) == ["lock-unnamed"]
    assert _fixture(tmp_path, "lock_unnamed_ok")["findings"] == []


def test_lock_order_cycle_detected_across_functions(tmp_path):
    bad = _fixture(tmp_path, "lock_cycle_bad")
    assert _rules(bad) == ["lock-order-cycle"]
    assert "'a'" in bad["findings"][0]["msg"]
    assert _fixture(tmp_path, "lock_cycle_ok")["findings"] == []


def test_lock_order_cycle_via_method_call_expansion(tmp_path):
    assert "lock-order-cycle" in _rules(
        _fixture(tmp_path, "lock_cycle_expansion"))


def test_lock_blocking_call_trips_and_waiver_suppresses(tmp_path):
    assert _rules(_fixture(tmp_path, "lock_blocking_bad")) == \
        ["lock-blocking-call"]
    waived = _fixture(tmp_path, "lock_blocking_waived")
    assert waived["findings"] == []
    assert waived["waived"] == 1


def test_lock_wait_no_loop_trips_and_while_is_clean(tmp_path):
    assert _rules(_fixture(tmp_path, "lock_wait_bad")) == \
        ["lock-wait-no-loop"]
    assert _fixture(tmp_path, "lock_wait_ok")["findings"] == []


# -- seam rules -------------------------------------------------------------

def test_seam_grammar_trips_on_bad_literal(tmp_path):
    assert _rules(_fixture(tmp_path, "seam_grammar_bad")) == ["seam-grammar"]


def test_seam_untested_trips_and_test_reference_cleans(tmp_path):
    assert _rules(_fixture(tmp_path, "seam_untested")) == ["seam-untested"]
    assert _fixture(tmp_path, "seam_tested")["findings"] == []


def test_seam_dynamic_scope_prefix_checked(tmp_path):
    assert _fixture(tmp_path, "seam_dynamic_ok")["findings"] == []
    assert _rules(_fixture(tmp_path, "seam_dynamic_bad")) == ["seam-grammar"]


# -- metrics rules ----------------------------------------------------------

def test_metrics_unpaired_trips_and_unregister_cleans(tmp_path):
    assert _rules(_fixture(tmp_path, "metrics_unpaired")) == \
        ["metrics-unpaired"]
    assert _fixture(tmp_path, "metrics_paired")["findings"] == []


def test_metrics_name_grammar(tmp_path):
    assert _rules(_fixture(tmp_path, "metrics_name_bad")) == ["metrics-name"]
    assert _fixture(tmp_path, "metrics_name_ok")["findings"] == []


def test_metrics_registry_mismatch_trips_and_paired_release_cleans(
        tmp_path):
    """Registering into a caller-supplied registry while releasing only
    through the global REGISTRY leaks every gauge on a private registry;
    (registry, name) pairs and global-only registrations are clean."""
    bad = _fixture(tmp_path, "metrics_mismatch")
    assert _rules(bad) == ["metrics-registry-mismatch"]
    assert "(registry, name)" in bad["findings"][0]["msg"]
    assert _fixture(tmp_path, "metrics_pairs_ok")["findings"] == []
    assert _fixture(tmp_path, "metrics_global_ok")["findings"] == []


def test_metrics_source_unreleased_is_corpus_wide(tmp_path):
    """register_source coverage crosses the package boundary (a helper
    beside the port counts) and file boundaries (a release literal in
    another file of the port covers it)."""
    bad = _fixture(tmp_path, "metrics_orphan")
    assert _rules(bad) == ["metrics-source-unreleased"]
    assert bad["findings"][0]["path"] == "bench_helper.py"
    assert _fixture(tmp_path,
                    "metrics_orphan_released_elsewhere")["findings"] == []
    assert _fixture(tmp_path,
                    "metrics_orphan_released_here")["findings"] == []


# -- env-knob rules ---------------------------------------------------------

def test_env_knob_direct_read_trips(tmp_path):
    assert _rules(_fixture(tmp_path, "env_direct_bad")) == \
        ["env-knob-direct"]
    # writes are exempt (a harness builds child environments)
    assert _fixture(tmp_path, "env_write_ok")["findings"] == []


def test_env_knob_undeclared_accessor_trips(tmp_path):
    assert _rules(_fixture(tmp_path, "env_undeclared")) == \
        ["env-knob-undeclared"]
    assert _fixture(tmp_path, "env_declared")["findings"] == []


def test_env_knob_undocumented_against_fixture_readme(tmp_path):
    name = "REFLOW_TEST_UNDOC_KNOB"
    declare(name, "flag", False, "fixture-only knob")
    try:
        bad = _lint(tmp_path / "a", {"README.md": "# nothing\n"},
                    passes=["envknobs"], rules=["env-knob-undocumented"])
        assert any(name in f["msg"] for f in bad["findings"])
        ok = _lint(tmp_path / "b", {"README.md": (
            "## The PyTorch/CUDA port (`reflow_tpu_torch`)\n\n"
            + "\n".join(f"| `{k}` |" for k in KNOBS) + "\n")},
            passes=["envknobs"], rules=["env-knob-undocumented"])
        assert ok["findings"] == []
        # a knob named outside the port's section documents nothing
        out = _lint(tmp_path / "c", {"README.md": (
            "\n".join(f"| `{k}` |" for k in KNOBS)
            + "\n## The PyTorch/CUDA port\n\n## Architecture\n")},
            passes=["envknobs"], rules=["env-knob-undocumented"])
        assert len(out["findings"]) == len(KNOBS)
    finally:
        del KNOBS[name]


# -- exception policy -------------------------------------------------------

def test_bare_assert_trips_and_raise_is_clean(tmp_path):
    assert _rules(_fixture(tmp_path, "bare_assert")) == ["bare-assert"]
    assert _fixture(tmp_path, "typed_raise")["findings"] == []
    # the port's tests are exempt: pytest rewrites asserts
    assert _fixture(tmp_path, "assert_in_test")["findings"] == []


# -- waiver grammar ---------------------------------------------------------

def test_waiver_without_reason_is_a_finding(tmp_path):
    assert _rules(_fixture(tmp_path, "waiver_no_reason")) == \
        ["waiver-no-reason"]


def test_waiver_with_reason_suppresses_and_counts(tmp_path):
    rep = _fixture(tmp_path, "waiver_reason")
    assert rep["findings"] == []
    assert rep["waived"] == 1


# -- socket rules -----------------------------------------------------------

def test_socket_naked_recv_and_connect_trip(tmp_path):
    rep = _fixture(tmp_path, "socket_naked")
    assert _rules(rep) == ["socket-no-timeout"]
    assert len(rep["findings"]) == 2


def test_socket_deadline_in_function_is_clean(tmp_path):
    assert _fixture(tmp_path, "socket_deadline")["findings"] == []


def test_socket_rule_scoped_to_socket_importers(tmp_path):
    # a scheduler's .connect() / .accept() must not trip the rule
    assert _fixture(tmp_path, "socket_non_importer")["findings"] == []


def test_socket_waiver_suppresses_with_reason(tmp_path):
    rep = _fixture(tmp_path, "socket_waived")
    assert rep["findings"] == []
    assert rep["waived"] == 1


def test_report_schema_shape(tmp_path):
    rep = _lint(tmp_path / "a", {"{P}/m.py": "x = 1\n"})
    assert rep["schema"] == "reflow.lint/1"
    assert set(rep) >= {"root", "files_scanned", "passes", "findings",
                        "counts", "waived"}


def test_walker_skips_pycache(tmp_path):
    rep = _fixture(tmp_path, "pycache_skipped")
    assert rep["files_scanned"] == 1
    assert rep["findings"] == []


def test_repo_is_lint_clean():
    """The acceptance gate: the port's tree has zero findings; the JAX
    package's six waivers are carried over with their reasons."""
    rep = run(str(ROOT))
    assert rep["findings"] == [], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['msg']}"
        for f in rep["findings"])


# -- parity with the JAX passes ---------------------------------------------

def _keyed(report, pkg):
    """The findings as a set of (rule, path, line), the package prefix
    replaced by ``{P}``."""
    return {(f["rule"], f["path"].replace(pkg + "/", "{P}/", 1), f["line"])
            for f in report["findings"]}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_findings_match_the_jax_passes(tmp_path, name):
    """The same tree under ``reflow_tpu/`` for the JAX passes and under
    ``reflow_tpu_torch/`` for the port's gives the same findings, rule,
    path and line, and the same waived count."""
    port = _fixture(tmp_path, name, PORT, run)
    ref = _fixture(tmp_path, name, JAX, jax_run)
    assert _keyed(port, PORT) == _keyed(ref, JAX)
    assert port["waived"] == ref["waived"]


def test_seam_coverage_counts_only_port_tests(tmp_path):
    """The one intended difference: a seam named only by a JAX test is
    covered for the JAX pass and untested for the port's."""
    files = {"{P}/m.py": ("class C:\n"
                          "    def f(self):\n"
                          "        self._crash_point('lonely_seam')\n"),
             "tests/test_x.py": "inj = CrashInjector(1, only='lonely_seam')\n"}
    root = tmp_path / "jax"
    _write(root, files, JAX)
    assert jax_run(str(root), passes=["seams"])["findings"] == []
    port = _lint(tmp_path / "port", files, passes=["seams"])
    assert [(f["rule"], f["path"], f["line"]) for f in port["findings"]] \
        == [("seam-untested", "reflow_tpu_torch/m.py", 3)]


def test_frontend_seams_need_their_port_tests(tmp_path):
    """The frontend's seams are covered by the port's own tests: cut the
    crash-seam tests out of ``test_torch_serve.py`` and the port flags
    exactly three seams of ``serve/frontend.py``; keep them and it flags
    none."""
    front = "reflow_tpu_torch/serve/frontend.py"
    marker = "# -- the frontend's crash seams"
    for keep in (False, True):
        root = tmp_path / f"keep{keep}"
        (root / "reflow_tpu_torch/serve").mkdir(parents=True)
        (root / "tests").mkdir()
        shutil.copy(ROOT / front, root / front)
        for t in sorted((ROOT / "tests").glob("test_torch_*.py")):
            if t.name == Path(__file__).name:
                continue
            text = t.read_text()
            if t.name == "test_torch_serve.py" and not keep:
                text = text[:text.index(marker)]
            (root / "tests" / t.name).write_text(text)
        rep = run(str(root), passes=["seams"])
        if keep:
            assert rep["findings"] == []
        else:
            assert _rules(rep) == ["seam-untested"]
            assert {f["path"] for f in rep["findings"]} == {front}
            seams = {s.split("@")[0] for s, _ln, _p in _seam_literals(
                ast.parse((ROOT / front).read_text()))}
            flagged = {f["msg"].split("'")[1] for f in rep["findings"]}
            assert len(flagged) == 3 and flagged <= seams


# -- scope ------------------------------------------------------------------

def test_port_passes_see_only_the_port(tmp_path):
    """A raw lock in the JAX package is the JAX pass's finding, not the
    port's; the same lock in the port's tree is the port's."""
    files, kw = FIXTURES["lock_unnamed_bad"]
    root = tmp_path / "jax"
    _write(root, files, JAX)
    assert run(str(root), **kw)["findings"] == []
    assert _rules(jax_run(str(root), **kw)) == ["lock-unnamed"]
    root = tmp_path / "port"
    _write(root, files, PORT)
    assert _rules(run(str(root), **kw)) == ["lock-unnamed"]
    assert jax_run(str(root), **kw)["findings"] == []


def test_analysis_package_is_outside_its_own_scope(tmp_path):
    rep = _lint(tmp_path / "a", {"{P}/analysis/m.py": (
        "import threading\n"
        "L = threading.Lock()\n"
        "assert L\n")}, passes=["locks", "exceptions"])
    assert rep["findings"] == []


# -- the CLI ----------------------------------------------------------------

def _cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "reflow_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))


def test_cli_json_report_and_exit_codes(tmp_path):
    out = _cli("--json")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep["schema"] == "reflow.lint/1"
    assert rep["findings"] == [] and rep["files_scanned"] > 0
    _write(tmp_path, FIXTURES["bare_assert"][0], PORT)
    bad = _cli("--json", "--root", str(tmp_path), "--passes", "exceptions")
    assert bad.returncode == 1
    assert json.loads(bad.stdout)["counts"] == {"bare-assert": 1}
    assert _cli("--passes", "nope", "--root", str(tmp_path)).returncode == 2
    assert _cli("--no-such-flag").returncode == 2


def test_cli_rule_catalogue_is_the_jax_one_but_the_hlo_audit():
    out = _cli("--list-rules")
    assert out.returncode == 0, out.stderr
    listed = {ln.split()[0] for ln in out.stdout.splitlines() if ln.strip()}
    import_passes()
    from reflow_tpu.analysis import (constants, envknobs,  # noqa: F401
                                     exceptions, locks, metrics_pass,
                                     seams, sockets, spans)
    assert listed == set(RULES) == set(JAX_RULES) - \
        {"hlo-multi-element-constant"}


def test_port_is_lint_clean():
    """``findings == []``, and the waived findings are exactly those the
    six waivers carried over from the JAX package cover: one each but
    ``named_lock``'s line, which makes both a Lock and an RLock (the JAX
    pass counts the same seven on its six lines)."""
    rep = run(str(ROOT))
    assert rep["findings"] == []
    assert rep["waived"] == 7
    marker = "# reflow-lint: " + "waive"
    sites = [(p.relative_to(ROOT).as_posix(), i)
             for p in sorted((ROOT / PORT).rglob("*.py"))
             if "analysis" not in p.parts
             for i, ln in enumerate(p.read_text().splitlines(), 1)
             if ln.lstrip().startswith(marker)]
    assert [s for s, _ in sites] == [
        "reflow_tpu_torch/serve/replica.py",
        "reflow_tpu_torch/utils/runtime.py",
        "reflow_tpu_torch/utils/runtime.py",
        "reflow_tpu_torch/wal/log.py", "reflow_tpu_torch/wal/log.py",
        "reflow_tpu_torch/wal/log.py"]
    ref = jax_run(str(ROOT), passes=["locks"])
    assert ref["waived"] == 7 and ref["findings"] == []


def test_readme_carries_the_knob_table():
    assert knob_table() in (ROOT / "README.md").read_text()


# -- runtime lock-order monitor (the port's utils/runtime.py) ---------------

def _wrapped(name, mon, *, reentrant=False):
    inner = threading.RLock() if reentrant else threading.Lock()
    return NamedLock(name, inner, mon)


def test_lockcheck_cycle_across_two_threads():
    """Thread 1 establishes a->b; thread 2 then tries b->a and gets
    LockOrderError instead of a deadlock."""
    mon = LockOrderMonitor()
    a, b = _wrapped("a", mon), _wrapped("b", mon)
    ready = threading.Event()
    err: list = []

    def t1():
        with a:
            with b:
                pass
        ready.set()

    def t2():
        ready.wait(5)
        try:
            with b:
                try:
                    with a:
                        pass
                except LockOrderError as e:
                    err.append(e)
        except LockOrderError as e:  # pragma: no cover - either site
            err.append(e)

    th1 = threading.Thread(target=t1)
    th2 = threading.Thread(target=t2)
    th1.start()
    th1.join(5)
    th2.start()
    th2.join(5)
    assert len(err) == 1
    msg = str(err[0])
    assert "'a'" in msg and "'b'" in msg and "cycle" in msg


def test_lockcheck_consistent_order_is_silent():
    mon = LockOrderMonitor()
    a, b = _wrapped("a", mon), _wrapped("b", mon)
    for _ in range(3):
        with a:
            with b:
                pass
    assert mon.edges() == {"a": {"b"}}


def test_lockcheck_transitive_cycle_detected():
    mon = LockOrderMonitor()
    a, b, c = (_wrapped(n, mon) for n in "abc")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(LockOrderError):
        with c:
            with a:
                pass


def test_lockcheck_rlock_reentry_is_not_a_cycle():
    mon = LockOrderMonitor()
    a = _wrapped("a", mon, reentrant=True)
    with a:
        with a:  # same instance: recursion, not a second acquisition
            pass
    assert mon.edges() == {}


def test_lockcheck_same_name_two_instances_raises():
    mon = LockOrderMonitor()
    a1, a2 = _wrapped("x", mon), _wrapped("x", mon)
    with a1:
        with pytest.raises(LockOrderError, match="distinct"):
            a2.acquire()


def test_lockcheck_condition_wait_keeps_held_list_balanced():
    mon = LockOrderMonitor()
    lk = _wrapped("cv.lock", mon, reentrant=True)
    cv = threading.Condition(lk)
    hit = threading.Event()
    leftover: list = []  # thread asserts don't reach pytest; collect

    def waiter():
        with cv:
            hit.set()
            cv.wait(timeout=5)
        # after the wait returns, this thread must hold nothing
        leftover.extend(mon.held_names())

    th = threading.Thread(target=waiter)
    th.start()
    hit.wait(5)
    with cv:
        cv.notify_all()
    th.join(5)
    assert not th.is_alive()
    assert leftover == []


def test_named_lock_factory_is_plain_when_disabled(monkeypatch):
    monkeypatch.delenv("REFLOW_LOCKCHECK", raising=False)
    lk = named_lock("plain.off")
    assert not isinstance(lk, NamedLock)
    monkeypatch.setenv("REFLOW_LOCKCHECK", "1")
    lk2 = named_lock("wrapped.on")
    assert isinstance(lk2, NamedLock)
    with lk2:
        pass  # acquire/release round-trips through the monitor


# -- the lockcheck leg, small, on the CPU -----------------------------------

def test_lockcheck_leg_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s lockcheck leg (phase 17) in a child process with
    ``REFLOW_LOCKCHECK=1``, at small widths on CPU tensors: the tier, the
    durable path and a failover, every table held to its twin, with no
    ``LockOrderError`` on any thread and edges of the tier's, the WAL's
    and a frontend's locks in the monitor's graph."""
    out = tmp_path / "lockcheck.json"
    env = dict(os.environ)
    env["REFLOW_LOCKCHECK"] = "1"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--lockcheck-child",
         str(out), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["lock_order_errors"] == []
    edges = res["edges"]
    assert edges and res["cycles_checked"] > 0
    names = set(edges) | {b for tos in edges.values() for b in tos}
    for fam in ("serve.tier", "wal.", "serve.frontend."):
        assert any(n.startswith(fam) for n in names), fam
    assert res["launches"] == [0, 0, 0]   # the plain versions off the card


def test_lockcheck_unseen_maps_dynamic_names():
    """A runtime edge counts as seen when a static edge joins the names
    or the dynamic families (``prefix*``) they fall under."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import lockcheck_unseen

    static = {"serve.replica.*": {"wal.log"}, "wal.log": {"wal.sync"}}
    runtime = {"serve.replica.r0": ["wal.log", "kernels.topk.tally"],
               "wal.log": ["wal.sync", "serve.tier"]}
    assert lockcheck_unseen(runtime, static) == [
        ("serve.replica.r0", "kernels.topk.tally"),
        ("wal.log", "serve.tier")]
