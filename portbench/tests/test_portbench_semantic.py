"""The semantic byte count on a hand-computed case, and the roofline share."""

import pytest

from portbench import semantic


def test_semantic_bytes_by_hand():
    # 1,000 user writes at 36 B, 400 GC writes at 20 B, 5 segments of 128
    # blocks reclaimed at 16 B of validity bits each
    assert semantic.replay_bytes(128, 1000, 400, 5) == 36_000 + 8_000 + 80


def test_roofline_share():
    assert semantic.roofline_pct(3_350_000_000, 1.0) == pytest.approx(0.1)
    assert semantic.roofline_pct(3_350_000_000_000, 1.0) == pytest.approx(100.0)
