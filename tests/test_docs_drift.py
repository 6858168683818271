"""Mechanical guard against performance-number drift in shipped source.

VERDICT r3/r4 both flagged docstrings whose measured-throughput claims
contradicted the current bench artifacts (a "7.0 Gsamp/s" comment surviving
two rounds after the kernel hit 13).  Rule enforced here: a throughput /
bandwidth figure may appear in ofdm_jax/ source ONLY as a dated
measurement snapshot ("measured 2026-08-18: ...", i.e. explicitly
historical provenance); undated numbers read as current claims and must
live in bench/results_*.json / BASELINE.md instead.
"""

import pathlib
import re

UNIT = re.compile(r"\d[\d.]*\s*x?\s*(?:G|M)samp/s|\d[\d.]*\s*GB/s"
                  r"|\d[\d.]*\s*TFLOP")
DATE = re.compile(r"20\d\d-\d\d(-\d\d)?")
CONTEXT = 3  # a date within this many preceding lines blesses the figure

PKG = pathlib.Path(__file__).resolve().parent.parent / "ofdm_jax"


def test_no_undated_perf_figures_in_source():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not UNIT.search(line):
                continue
            window = lines[max(0, i - CONTEXT): i + 1]
            if not any(DATE.search(w) for w in window):
                offenders.append(f"{path.relative_to(PKG.parent)}:{i + 1}: "
                                 f"{line.strip()}")
    assert not offenders, (
        "undated perf figures in source (cite a measurement date or point "
        "at bench/results_*.json):\n" + "\n".join(offenders)
    )
