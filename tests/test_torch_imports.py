"""The port imports torch, numpy and the standard library only.

Every module of ``dragonfly2_tpu_torch`` and ``chip_smoke.py`` is imported
in a fresh interpreter whose meta path refuses JAX, its companions, the
network stacks the slice does without, and the JAX package itself.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "optax", "flax", "ml_dtypes", "aiohttp", "grpc",
           "dragonfly2_tpu")

_SCRIPT = """
import importlib, pkgutil, sys

BLOCKED = {blocked!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import dragonfly2_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    dragonfly2_tpu_torch.__path__, "dragonfly2_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(blocked=BLOCKED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slice was found and imported
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25, proc.stdout
