"""Run the reference's own test files against ``dragonfly2_tpu_torch``.

A wrapper ``tests/test_torch_ref_<name>.py`` holds three things:

- ``SUBSTITUTIONS``: ``(old, new, reason)`` triples applied to the
  reference file's source after the package rename. Each names an
  accepted difference (a ``Daemon`` or fit that must name the CPU, a
  known difference of ``ROADMAP.md``); none loosens an assertion.
- ``EXCLUDED``: ``{"test_x" or "TestClass::test_x": reason}``, the
  reference's cases that do not run on the port, each with one of the
  reasons that ``REASON_FORMS`` accepts.
- ``globals().update(load(name, SUBSTITUTIONS, EXCLUDED))``.

``load`` reads ``tests/test_<name>.py`` (never editing it), rewrites
``dragonfly2_tpu`` to ``dragonfly2_tpu_torch`` everywhere in it (its
imports and its ``monkeypatch`` target strings alike) and ``test_<x>``
imports to ``refport_<x>``, applies the substitutions, and executes the
result as the fresh module ``refport_<name>`` in ``sys.modules``. A
reference file that imports another (``from test_daemon_e2e import
daemon_config``) gets that file's port module, loaded first through its
own wrapper when it has one, so it carries that wrapper's substitutions.

``tests/test_torch_refcases.py`` holds every wrapper to the reference
file: the cases it collects plus ``EXCLUDED`` are the file's cases.
"""

from __future__ import annotations

import ast
import importlib
import importlib.abc
import importlib.util
import os
import re
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
PREFIX = "refport_"

_PACKAGE = re.compile(r"\bdragonfly2_tpu\b")
_TEST_IMPORT = re.compile(r"\b(from|import)(\s+)test_(\w+)")

# the three forms an exclusion's reason may take
REASON_FORMS = {
    "known difference": re.compile(
        r"^known difference (\d+)\b.*\bpinned by "
        r"(tests/test_torch_\w+\.py::[\w:\[\]\-.]+)", re.S),
    "JAX only": re.compile(r"^JAX only: `?([\w.]*jax[\w.]*)`?", re.S | re.I),
    "covered by": re.compile(
        r"^covered by (tests/test_torch_\w+\.py::[\w:\[\]\-.]+)", re.S),
}

_SUBSTITUTIONS: dict[str, tuple] = {}


def reference_path(name: str) -> str:
    return os.path.join(TESTS, f"test_{name}.py")


def wrapper_path(name: str) -> str:
    return os.path.join(TESTS, f"test_torch_ref_{name}.py")


def _dependencies(src: str) -> list[str]:
    """The reference test files ``src`` imports (``from test_x import``)."""
    return sorted({m[3] for m in _TEST_IMPORT.finditer(src)})


def port_source(name: str, substitutions=()) -> str:
    """The reference file's source as the port runs it."""
    with open(reference_path(name)) as f:
        src = f.read()
    src = _PACKAGE.sub("dragonfly2_tpu_torch", src)
    src = _TEST_IMPORT.sub(lambda m: f"{m[1]}{m[2]}{PREFIX}{m[3]}", src)
    for old, new, reason in substitutions:
        if not reason.strip():
            raise ValueError(f"test_{name}.py: substitution {old!r} "
                             "carries no reason")
        if old not in src:
            raise ValueError(f"test_{name}.py: substitution {old!r} "
                             "matches nothing")
        src = src.replace(old, new)
    return src


def _compile(src: str, path: str):
    """Compile with pytest's assertion rewriting where it is available,
    so a failing reference assert reports its operands."""
    tree = ast.parse(src, path)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts
        rewrite_asserts(tree, src.encode(), path)
    except ImportError:
        pass
    return compile(tree, path, "exec", dont_inherit=True)


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if (fullname.startswith(PREFIX)
                and os.path.exists(reference_path(fullname[len(PREFIX):]))):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        name = module.__name__[len(PREFIX):]
        path = reference_path(name)
        with open(path) as f:
            deps = _dependencies(f.read())
        for dep in deps:
            # a file this one imports is loaded first, by its own wrapper
            # where it has one, so it carries that wrapper's substitutions
            if (PREFIX + dep not in sys.modules
                    and os.path.exists(wrapper_path(dep))):
                importlib.import_module(f"test_torch_ref_{dep}")
        module.__file__ = path
        src = port_source(name, _SUBSTITUTIONS.get(name, ()))
        exec(_compile(src, path), module.__dict__)


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.insert(0, _Finder())


def _split(excluded) -> tuple[set, dict]:
    funcs, methods = set(), {}
    for key in excluded:
        cls, _, meth = key.rpartition("::")
        if cls:
            methods.setdefault(cls, set()).add(meth)
        else:
            funcs.add(meth)
    return funcs, methods


@pytest.fixture(autouse=True)
def _refport_one_torch_thread():
    """Each case runs torch on one thread, as the port's own fit tests do:
    the suite runs several workers on one host, and a CPU fit that spreads
    over every core in each of them runs many times slower."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(name: str, substitutions=(), excluded=None) -> dict:
    """The port module of ``tests/test_<name>.py``: its tests, fixtures
    and helpers, less the ``excluded`` cases, and the one-thread fixture."""
    _SUBSTITUTIONS[name] = tuple(substitutions)
    module = importlib.import_module(PREFIX + name)
    funcs, methods = _split(excluded or {})
    names = {k: v for k, v in vars(module).items()
             if not (k.startswith("__") and k.endswith("__"))}
    names["_refport_one_torch_thread"] = _refport_one_torch_thread
    for key in funcs:
        if not callable(names.pop(key, None)):
            raise KeyError(f"test_{name}.py has no case {key}")
    for cls_name, meths in methods.items():
        base = names[cls_name]
        for m in meths:
            if not callable(getattr(base, m, None)):
                raise KeyError(f"test_{name}.py has no case "
                               f"{cls_name}::{m}")
        # a subclass hides the excluded methods; the reference's class
        # (which another file may import) is left as it is
        names[cls_name] = type(cls_name, (base,), {
            "__module__": base.__module__, "__qualname__": base.__qualname__,
            **{m: None for m in meths}})
    return names


def reference_cases(name: str) -> set[str]:
    """Every case pytest collects from the reference file, read with
    ``ast``: top-level ``test*`` functions and the ``test*`` methods of
    ``Test*`` classes (bases defined in the file included)."""
    with open(reference_path(name)) as f:
        tree = ast.parse(f.read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls: ast.ClassDef) -> set[str]:
        out = {n.name for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and n.name.startswith("test")}
        for b in cls.bases:
            if isinstance(b, ast.Name) and b.id in classes:
                out |= methods(classes[b.id])
        return out

    cases = set()
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name.startswith("test")):
            cases.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            cases |= {f"{node.name}::{m}" for m in methods(node)}
    return cases


def collected_cases(namespace: dict) -> set[str]:
    """The cases pytest collects from a wrapper's namespace, by its
    default ``python_functions`` and ``python_classes`` rules."""
    cases = set()
    for key, obj in namespace.items():
        if key.startswith("test") and callable(obj) and not isinstance(obj, type):
            cases.add(key)
        elif key.startswith("Test") and isinstance(obj, type):
            cases |= {f"{key}::{m}" for m in dir(obj)
                      if m.startswith("test") and callable(getattr(obj, m))}
    return cases
