"""The port stands alone: neither ``reflow_tpu_torch`` nor
``chip_smoke.py`` imports JAX or anything of the JAX package
(``reflow_tpu``), even its modules that do not import JAX. Checked twice:
by importing every module in a fresh interpreter and looking at
``sys.modules``, and by reading every import statement in the sources.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "reflow_tpu_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "orbax") \
        or top == "reflow_tpu"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("reflow_tpu_torch.executors.cuda",
              "reflow_tpu_torch.executors.fixpoint",
              "reflow_tpu_torch.executors.linear_fixpoint",
              "reflow_tpu_torch.executors.arena",
              "reflow_tpu_torch.executors.lowerings",
              "reflow_tpu_torch.workloads.pagerank",
              "reflow_tpu_torch.workloads.sssp",
              "reflow_tpu_torch.workloads.tfidf",
              "reflow_tpu_torch.workloads.wordcount",
              "reflow_tpu_torch.executors.ingress_queue",
              "reflow_tpu_torch.utils.faults",
              "reflow_tpu_torch.utils.metrics",
              "reflow_tpu_torch.utils.checkpoint",
              "reflow_tpu_torch.utils.tiles",
              "reflow_tpu_torch.wal.log",
              "reflow_tpu_torch.wal.durable",
              "reflow_tpu_torch.wal.recovery",
              "reflow_tpu_torch.wal.ship",
              "reflow_tpu_torch.wal.compact",
              "reflow_tpu_torch.serve.replica",
              "reflow_tpu_torch.serve.read",
              "reflow_tpu_torch.serve.failover",
              "reflow_tpu_torch.net.framing",
              "reflow_tpu_torch.obs.flight",
              "reflow_tpu_torch.obs.wire",
              "reflow_tpu_torch.obs.fleet",
              "reflow_tpu_torch.obs.export",
              "reflow_tpu_torch.subs.query",
              "reflow_tpu_torch.subs.wire",
              "reflow_tpu_torch.subs.hub",
              "reflow_tpu_torch.subs.client",
              "reflow_tpu_torch.subs.cli",
              "reflow_tpu_torch.proc.ownership",
              "reflow_tpu_torch.proc.worker",
              "reflow_tpu_torch.proc.harness"):
        assert m in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"the port loaded {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert not _forbidden(n), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {n}")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run where no CUDA device is visible: a non-zero exit and no result
    line (this environment has no card; on a machine with one, the
    device is hidden from the child)."""
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_refuses(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails before printing any result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
