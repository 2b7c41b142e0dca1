"""The reference's ``tests/test_dfbench.py`` run against the port
(``tests/_refcases.py``)."""

from _refcases import load

_OUT = ("known difference 76: the port's dfbench prints its result unless "
        "--out names a file, where the reference writes BENCH_pr<N>.json in "
        "its working directory by default; these cases name the file the "
        "reference writes")
_FIT_CPU = ("the port's fits run on CUDA unless the CPU is named, and "
            "raise without CUDA (ROADMAP ground rules; known difference 51 "
            "for the --device flag)")

SUBSTITUTIONS = tuple(
    (f'"--pr{n}", "--seed", "7"],',
     f'"--pr{n}", "--seed", "7", "--out", "BENCH_pr{n}.json"],', _OUT)
    for n in (5, 6, 8, 10, 11, 12)) + (
    ('dfbench",\n             "--seed", "7", "--daemons", "4", "--pieces", '
     '"8"],',
     'dfbench",\n             "--seed", "7", "--daemons", "4", "--pieces", '
     '"8", "--out", "BENCH_pr3.json"],', _OUT),
    ('"--pr4", "--seed", "7", "--daemons", "4", "--pieces", "8"],',
     '"--pr4", "--seed", "7", "--daemons", "4", "--pieces", "8",\n'
     '             "--out", "BENCH_pr4.json"],', _OUT),
    ('"--pr19", "--smoke", "--seed", "7"],',
     '"--pr19", "--smoke", "--seed", "7", "--device", "cpu"],', _FIT_CPU),
    ("use_mesh=False)", 'use_mesh=False, device="cpu")', _FIT_CPU),
)

EXCLUDED = {
    "TestPr17Recovery::test_pr17_smoke_stdout_only_and_committed_digest": (
        "known difference 13: the port's swap-partner ruling moves --pr17's "
        "recovery digest off BENCH_pr17.json's; with the reference's filter "
        "the port equals the file, pinned by tests/test_torch_dfbench.py::"
        "test_full_size_pr17_equals_the_committed_file_but_its_wall_clock"),
}

globals().update(load("dfbench", SUBSTITUTIONS, EXCLUDED))
