"""`repro_torch`, `chip_smoke.py` and the port's benchmarks and examples
never import JAX or the JAX package."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "benchmarks" / "port").rglob("*.py")) + \
    sorted((ROOT / "examples" / "port").rglob("*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_jax_or_repro():
    assert len(SOURCES) > 15
    for path in SOURCES:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert len(names) > 15, names
assert not bad, bad
print('ok', len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
