"""Ops answered in the window over the window's seconds: point and range
ops alike, a coalesced SEARCH too (its client got an answer)."""


def read(run):
    ids, _ = run.answered_in_window()
    return ids.size / run.seconds
