"""Rolling-rewrite replay harness.

Port of spittle_tpu/text/rolling.py.

Behavior-parity port of `src-tauri/src/rolling_harness.rs`:
replays a sequence of live-transcription hypotheses against a virtual text
buffer under injected fault strategies (Perfect vs UnderDeletePerRewrite)
to detect rewrite drift without any keyboard/OS involvement. Scenario JSONs
live in tests/data/rolling_scenarios (mirrored from the reference).

Also provides the CLI driver semantics of the reference binary
(`src-tauri/src/bin/rolling_harness.rs`): consume scenario files, print a
PASS/FAIL drift report.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import List, Sequence, Union

_SPACE_BEFORE_PUNCT = re.compile(r"\s+([,.;:!?])")


@dataclass
class ReplayScenario:
    name: str
    hypotheses: List[str] = field(default_factory=list)


@dataclass(frozen=True)
class Perfect:
    """Ideal behavior: each rewrite fully replaces the rolling text."""


@dataclass(frozen=True)
class UnderDeletePerRewrite:
    """Fault injection: N chars of the previous text survive each rewrite."""

    remaining: int


RewriteStrategy = Union[Perfect, UnderDeletePerRewrite]


@dataclass
class ReplayReport:
    hypotheses_count: int
    final_expected: str
    final_actual: str
    rewrites_applied: int
    matches_expected: bool


def normalize_hypothesis(text: str) -> str:
    """Collapse whitespace and drop space-before-punctuation, preserving the
    model's casing/punctuation (rolling-mode normalization)."""
    collapsed = " ".join(text.split())
    return _SPACE_BEFORE_PUNCT.sub(r"\1", collapsed.strip())


def normalize_scenario(scenario: ReplayScenario) -> ReplayScenario:
    hyps = [normalize_hypothesis(h) for h in scenario.hypotheses]
    return ReplayScenario(scenario.name, [h for h in hyps if h])


def replay_hypotheses(
    hypotheses: Sequence[str], strategy: RewriteStrategy
) -> ReplayReport:
    buffer = ""
    rewrites = 0
    last_emitted = ""
    for hyp in hypotheses:
        if not last_emitted:
            buffer += hyp
            last_emitted = hyp
            continue
        rewrites += 1
        if isinstance(strategy, Perfect):
            buffer = hyp
        else:
            prefix = last_emitted[: strategy.remaining]
            buffer = prefix + hyp
        last_emitted = hyp
    final_expected = hypotheses[-1] if hypotheses else ""
    return ReplayReport(
        hypotheses_count=len(hypotheses),
        final_expected=final_expected,
        final_actual=buffer,
        rewrites_applied=rewrites,
        matches_expected=buffer == final_expected,
    )


def load_scenario(path: str) -> ReplayScenario:
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    return ReplayScenario(name=raw["name"], hypotheses=list(raw["hypotheses"]))


def run_scenario_file(path: str, under_delete: int = 1) -> List[str]:
    """CLI-style report lines: PASS/FAIL for Perfect and the fault strategy."""
    scenario = normalize_scenario(load_scenario(path))
    lines = []
    perfect = replay_hypotheses(scenario.hypotheses, Perfect())
    lines.append(
        f"{scenario.name} [perfect]: "
        f"{'PASS' if perfect.matches_expected else 'FAIL'}"
    )
    drift = replay_hypotheses(
        scenario.hypotheses, UnderDeletePerRewrite(under_delete)
    )
    expected_fail = drift.matches_expected is False or len(scenario.hypotheses) < 2
    lines.append(
        f"{scenario.name} [under-delete {under_delete}]: "
        f"{'DRIFT-DETECTED' if not drift.matches_expected else 'NO-DRIFT'}"
    )
    return lines


def main(argv: Sequence[str]) -> int:
    ok = True
    for path in argv:
        for line in run_scenario_file(path):
            print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
