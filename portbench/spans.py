"""The port's own spans and counters (``utils.profiling`` of
``news_recommendation_project_v2_torch``), as recorded in the traced unit
after the window: tracing is on only there in a run. A program without the
recorder reads as nothing recorded."""

from __future__ import annotations


def recorded():
    """The port's ``(spans, counters)``, or ``None`` where it records none."""
    try:
        from news_recommendation_project_v2_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return None if read is None else read()


def span_share(r, kind: str, part: str, whole: str):
    """The percent of the spans ``whole``'s seconds that the spans ``part``
    take (each summed over the traced unit), in a ``--trace 1`` run of a
    ``kind`` cell; ``None`` without them."""
    rec = recorded() if r.kind == kind and r.trace is not None else None
    if not rec:
        return None
    total = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == whole)
    if total <= 0:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in rec.spans if s.name == part) / total


def pad_share(r, kind: str, prefix: str):
    """The percent of the tokens the unit computed that were padding:
    ``100 x (computed - real) / computed`` of the counters
    ``<prefix>.tokens_computed`` and ``<prefix>.tokens_real``."""
    rec = recorded() if r.kind == kind and r.trace is not None else None
    if not rec:
        return None
    computed = rec.counters.get(f"{prefix}.tokens_computed", 0)
    if computed <= 0:
        return None
    return 100.0 * (computed - rec.counters.get(f"{prefix}.tokens_real", 0)) / computed
