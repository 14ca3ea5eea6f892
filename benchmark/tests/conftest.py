"""Shared helpers of the benchmark's tests: small cells on the CPU built from
the committed configuration and traffic files with the deck cut down."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# cell -> (config, traffic, small deck arguments)
SMALL = {"cavity_ne85184.explicit": ("cavity_ne85184", "developed.fused_cg", [4])}


def small_spec(cell: str, segment: int = 6, first: int = 2, sampled: int = 1):
    """The :class:`harness.Spec` of ``cell`` with its deck cut to a few
    elements, a short segment, warm-up, development and check, no setup
    cache."""
    from benchmark.harness import HERE, Spec, _json, load_spec

    full = load_spec(cell)
    config, traffic, args = SMALL[cell]
    c = _json(HERE / "configs" / f"{config}.json")
    t = _json(HERE / "traffic" / f"{traffic}.json")
    c["deck"]["args"] = args
    c["solver"]["setup_cache"] = None
    t["segment_steps"] = segment
    t["warmup_steps"] = 2
    t["start"]["developed_steps"] = 4
    t["check"].update(first_steps=first, sampled=sampled)
    return Spec(cell=full.cell, config=c, traffic=t, limits=full.limits,
                end_to_end=full.end_to_end, per_layer=full.per_layer)


@pytest.fixture
def small():
    return small_spec
