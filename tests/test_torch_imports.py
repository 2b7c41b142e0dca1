"""The port imports torch, numpy and the standard library only.

Every import statement of ``dragonfly2_tpu_torch`` and ``chip_smoke.py``,
at module level or inside a function, must name a module of the standard
library (``sys.stdlib_module_names``), ``torch``, ``numpy`` or the port
itself: the card's machine has no ``jax``, ``grpc``, ``aiohttp`` or
``msgpack``, and an import of one of them would pass every CPU test and
fail only there. The statements are read from the source, and every
module is then imported in a fresh interpreter whose meta path refuses
any other import made by a module of the port.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dragonfly2_tpu_torch")
ALLOWED = frozenset(sys.stdlib_module_names) | {"torch", "numpy",
                                                "dragonfly2_tpu_torch"}

_SCRIPT = """
import importlib, pkgutil, sys

ALLOWED = {allowed!r}
refused = []

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ALLOWED:
            return None
        frame = sys._getframe(1)
        while frame is not None and frame.f_globals.get(
                "__name__", "").startswith(("importlib", "_frozen")):
            frame = frame.f_back
        importer = frame.f_globals.get("__name__", "") if frame else ""
        if importer == "chip_smoke" or importer.startswith(
                "dragonfly2_tpu_torch"):
            refused.append(importer + " -> " + name)
            raise ImportError("not allowed in the port: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import dragonfly2_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    dragonfly2_tpu_torch.__path__, "dragonfly2_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not refused, refused
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "dragonfly2_tpu"))
assert not leaked, leaked
print(len(names))
"""


def _sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_import_statement_is_stdlib_torch_or_numpy():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] not in ALLOWED]
    assert not bad, bad


# the readers of the observability plane (ROADMAP Queue 1 item 4b): the
# reference's versions import aiohttp (the fleet route) or sit beside
# modules that do, so each is checked by name
READERS = ("common/podscope.py", "scheduler/fleetpulse.py",
           "daemon/pulse.py", "tools/dfdiag.py", "tools/dfsched.py")


@pytest.mark.parametrize("rel", READERS)
def test_the_observability_readers_import_only_the_allowed(rel):
    path = os.path.join(PORT, rel)
    assert path in _sources()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= ALLOWED, names
    assert not names & {"aiohttp", "jax", "dragonfly2_tpu"}


def test_port_imports_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(allowed=set(ALLOWED))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slice was found and imported
    assert int(proc.stdout.strip().splitlines()[-1]) >= 112, proc.stdout
