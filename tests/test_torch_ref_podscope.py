"""The reference's ``tests/test_podscope.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

SUBSTITUTIONS = ()

EXCLUDED = {
    "TestServeJournalGating::test_aborted_transmit_never_journals": (
        "known difference 75: the port's upload server journals a serve "
        "after the body's last write in its own handler, where the "
        "reference's aiohttp sends the body after the handler returns and "
        "gates the journal on _Slot.ok and _Slot.on_release; pinned by "
        "tests/test_torch_upload_surface.py::"
        "test_an_aborted_transmit_never_journals"),
}

globals().update(load("podscope", SUBSTITUTIONS, EXCLUDED))
