"""repro_torch stands alone: importing it pulls in neither jax nor the JAX
package, no source names them, and chip_smoke.py refuses to report a result
without a card or without the repository around it."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_repro():
    pattern = re.compile(r"import jax|from repro[. ]|import repro\b")
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Here there is no card: the script must fail and print no result;
    alone in a directory it must fail too."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=script.parent,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
             for script in (ROOT / "chip_smoke.py", alone)]
    for proc in procs:
        stdout, _ = proc.communicate(timeout=300)
        assert proc.returncode != 0
        assert stdout == ""
