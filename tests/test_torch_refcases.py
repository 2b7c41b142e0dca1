"""Every case of every wrapped reference file is run on the port or
excluded for a stated reason (``tests/_refcases.py``).

For each wrapper ``tests/test_torch_ref_<name>.py``: the cases it hands
pytest plus its ``EXCLUDED`` names are exactly the reference file's cases,
read with ``ast``, and every exclusion's reason is one of the three forms:
a known difference of ``ROADMAP.md`` with the port test that pins the
port's side, "JAX only" naming the JAX call, or "covered by" a named port
test. A reference case cannot vanish unnoticed, now or when the reference
changes.
"""

from __future__ import annotations

import glob
import importlib
import os
import re

import pytest

import _refcases

TESTS = _refcases.TESTS
REPO = os.path.dirname(TESTS)
WRAPPERS = sorted(
    os.path.basename(p)[len("test_torch_ref_"):-len(".py")]
    for p in glob.glob(os.path.join(TESTS, "test_torch_ref_*.py")))


def _known_differences() -> set[int]:
    """The numbers of ROADMAP.md's known differences (``- **N. ...``)."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("**Known differences**"):]
    return {int(n) for n in re.findall(r"^- \*\*(\d+)\. ", section, re.M)}


def _port_test_exists(ref: str) -> bool:
    """``tests/test_torch_x.py::[Class::]name[param]`` names a test
    defined in that file."""
    path, *parts = ref.split("::")
    name = parts[-1].split("[")[0]
    full = os.path.join(REPO, path)
    if not os.path.exists(full):
        return False
    with open(full) as f:
        src = f.read()
    if not re.search(rf"^\s*(async )?def {re.escape(name)}\(", src, re.M):
        return False
    return all(re.search(rf"^class {re.escape(c)}\b", src, re.M)
               for c in parts[:-1])


def test_there_are_wrappers():
    # groups A and B of the sweep: the data plane and the scheduler
    assert {"storage", "dataplane", "warm_restart", "common", "daemon_e2e",
            "p2p", "churn", "scheduler", "decisions", "swarm_machinery",
            "priority"} <= set(WRAPPERS)


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_reference_case_is_run_or_excluded(name):
    wrapper = importlib.import_module(f"test_torch_ref_{name}")
    excluded = set(wrapper.EXCLUDED)
    run = _refcases.collected_cases(vars(wrapper))
    ref = _refcases.reference_cases(name)
    assert not run & excluded, sorted(run & excluded)
    assert run | excluded == ref, {
        "not run nor excluded": sorted(ref - run - excluded),
        "not in the reference": sorted((run | excluded) - ref)}


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_exclusion_gives_a_reason_of_one_of_the_three_forms(name):
    wrapper = importlib.import_module(f"test_torch_ref_{name}")
    numbers = _known_differences()
    for case, reason in wrapper.EXCLUDED.items():
        forms = {form: rx.match(reason)
                 for form, rx in _refcases.REASON_FORMS.items()}
        matched = [f for f, m in forms.items() if m]
        assert len(matched) == 1, (case, reason)
        m = forms[matched[0]]
        if matched[0] == "known difference":
            assert int(m[1]) in numbers, (case, m[1])
            assert _port_test_exists(m[2]), (case, m[2])
        elif matched[0] == "covered by":
            assert _port_test_exists(m[1]), (case, m[1])


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_substitution_applies_and_carries_a_reason(name):
    wrapper = importlib.import_module(f"test_torch_ref_{name}")
    # port_source raises on a substitution that matches nothing or has no
    # reason; no substitution may touch an assert line
    _refcases.port_source(name, wrapper.SUBSTITUTIONS)
    for old, new, _ in wrapper.SUBSTITUTIONS:
        assert [ln for ln in old.splitlines() if "assert" in ln] == \
            [ln for ln in new.splitlines() if "assert" in ln], old


def test_the_wrapped_source_names_only_the_port_package():
    for name in WRAPPERS:
        src = _refcases.port_source(name)
        assert not re.search(r"\bdragonfly2_tpu\b", src), name
