"""The reference's ``tests/test_oci_mirror_e2e.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = (
    ("""if not cryptoshim.install():
    pytest.skip("no cryptography wheel and no openssl binary",
                allow_module_level=True)
""", "",
     "known difference 57: the port's certificates always go through its "
     "openssl shim, which is never installed in sys.modules, so there is "
     "no install() to call and nothing to skip"),
)

EXCLUDED = {}

globals().update(load("oci_mirror_e2e", SUBSTITUTIONS, EXCLUDED))
