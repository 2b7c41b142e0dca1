"""``chip_smoke.check_seed_uplink``, phase 15's account of the seed's
uplink, on the CPU: the bytes podscope's edges carry from the seed (what
the leechers landed from it) against the seed's upload counter (what it
sent), with the seed's serve journal between them.

The cases take phase 15's file (phase 8's 1,050,681,536 bytes in 84
pieces of 12 MiB) served twice over to four leechers, and the excess that
one H100 run of the phase showed: the counter 25,165,824 bytes (two
pieces) above what podscope saw land. The check must pass when the
journal or the relay serves cut short explain that excess, and fail when
nothing does.
"""
import collections
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

SIZE = 1_050_681_536
PIECE = 12 << 20
PIECES = -(-SIZE // PIECE)
LEECHERS = ("l1", "l2", "l3", "l4")
EXCESS = 2 * PIECE              # the run's counter minus podscope's bytes


def piece_bytes(num: int) -> int:
    return min(PIECE, SIZE - num * PIECE)


def fan_out():
    """The seed serves each piece to two leechers, one piece a serve, and
    each leecher lands what it was served: (journal, landings)."""
    serves, landed = [], collections.Counter()
    for num in range(PIECES):
        for peer in (LEECHERS[num % 4], LEECHERS[(num + 1) % 4]):
            serves.append((peer, num, 1, piece_bytes(num)))
            landed[(peer, num)] += 1
    return serves, landed


def account(serves, landed, *, uplink, uploaded, cut=None, relay=None,
            cap=8192):
    return chip_smoke.check_seed_uplink(
        uplink, serves, cap, landed, PIECE, SIZE, uploaded, cut or {},
        relay or {"ok": 0})


def test_the_fan_out_is_twice_the_file():
    serves, landed = fan_out()
    assert sum(row[3] for row in serves) == 2 * SIZE
    assert account(serves, landed, uplink=2 * SIZE,
                   uploaded=2 * SIZE) == (0, 0)


def test_serves_no_leecher_landed_explain_the_excess():
    """Two more 12 MiB serves went out in full, and their children landed
    the pieces from other parents: journaled, never landed."""
    serves, landed = fan_out()
    serves += [("l3", 0, 1, PIECE), ("l4", 1, 1, PIECE)]
    assert account(serves, landed, uplink=2 * SIZE,
                   uploaded=2 * SIZE + EXCESS) == (EXCESS, 0)


def test_relay_serves_cut_short_explain_the_excess():
    """Two relay serves stalled after sending a piece each: counted by
    the upload counter, journaled nowhere."""
    serves, landed = fan_out()
    assert account(serves, landed, uplink=2 * SIZE,
                   uploaded=2 * SIZE + EXCESS,
                   cut={"stall": EXCESS},
                   relay={"ok": 40, "stall": 2}) == (0, EXCESS)


@pytest.mark.parametrize("cut, relay", [
    ({}, {"ok": 40}),
    # a relay serve that failed after 1 MiB cannot cover 24 MiB
    ({"aborted": 1 << 20}, {"ok": 40, "aborted": 1}),
    # nor one that failed before its first byte
    ({}, {"ok": 40, "stall": 1}),
], ids=["no-relay-failure", "short-relay-failure", "relay-503"])
def test_an_unexplained_excess_fails(cut, relay):
    serves, landed = fan_out()
    left = EXCESS - sum(cut.values())
    with pytest.raises(chip_smoke.CheckFailed, match=rf"\b{left} unexpl"):
        account(serves, landed, uplink=2 * SIZE, uploaded=2 * SIZE + EXCESS,
                cut=cut, relay=relay)


def test_an_excess_above_its_explanation_fails():
    """The journal explains one of the two pieces: the other fails."""
    serves, landed = fan_out()
    serves.append(("l3", 0, 1, PIECE))
    with pytest.raises(chip_smoke.CheckFailed, match=r"\b12582912 unexp"):
        account(serves, landed, uplink=2 * SIZE, uploaded=2 * SIZE + EXCESS)


def test_podscope_short_of_the_landings_fails():
    """Podscope missing a landed piece is no excess of the counter."""
    serves, landed = fan_out()
    with pytest.raises(chip_smoke.CheckFailed):
        account(serves, landed, uplink=2 * SIZE - PIECE, uploaded=2 * SIZE)


def test_a_full_journal_fails():
    """A journal at its cap may have dropped serves: nothing is proved."""
    serves, landed = fan_out()
    with pytest.raises(chip_smoke.CheckFailed):
        account(serves, landed, uplink=2 * SIZE, uploaded=2 * SIZE,
                cap=len(serves))


def test_landings_the_seed_never_journaled_fail():
    """A piece landed from the seed that its journal lacks is no serve
    of the seed's: the edges then exceed the journal."""
    serves, landed = fan_out()
    landed[("l3", 0)] += 1
    with pytest.raises(chip_smoke.CheckFailed, match="landed from the "
                                                     f"seed {2 * SIZE + PIECE}"):
        account(serves, landed, uplink=2 * SIZE + PIECE, uploaded=2 * SIZE)
