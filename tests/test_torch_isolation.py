"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither ``jax`` nor ``repro``, and no source of
the port names them in an import."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_SCRIPT = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_import_loads_neither_jax_nor_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 12
    assert bad == "[]"


def test_no_port_source_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b(?!_)",
                         re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 13
    for path in files:
        text = path.read_text()
        assert "import jax" not in text, path
        assert "from repro." not in text, path
        assert not pattern.search(text), path
