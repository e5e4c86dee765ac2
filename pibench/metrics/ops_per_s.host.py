"""``ops_per_s`` in the cells where the host paces the served path and the
end-to-end rate is the card's (``card_ops_per_s``): the same reading."""
from pathlib import Path

from pibench import harness

read = harness.reader(Path(__file__).resolve().parents[2], "ops_per_s")
