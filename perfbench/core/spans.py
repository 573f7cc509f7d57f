"""The program's spans as the readers take them: each X event carries its
``span_id`` and the ``parent_id`` of the span open around it, so a span is
found under the span that caused it."""

from __future__ import annotations

from typing import List, Optional, Tuple


def under(run, name: str, ancestor: str) -> List[Tuple[dict, dict]]:
    """(span, its nearest ancestor named ``ancestor``) for each of the
    window's spans named ``name`` that lies under such a span (none from a
    program whose spans carry no ids)."""
    by_id = {s["span_id"]: s for s in run.spans if "span_id" in s}
    out = []
    for s in run.spans:
        if s["name"] != name or "span_id" not in s:
            continue
        p = by_id.get(s["parent_id"])
        while p is not None and p["name"] != ancestor:
            p = by_id.get(p["parent_id"])
        if p is not None:
            out.append((s, p))
    return out


def prefill_device_ms_per_ktok(run, name: str) -> Optional[float]:
    """Device milliseconds of the ``name`` spans inside the window's
    ``prefill`` spans per thousand of those prefills' prompt tokens; None
    where no such span holds a ``device_s`` (the CPU, or a program that
    does not time it)."""
    found = under(run, name, "prefill")
    if not found or any("device_s" not in s["args"] for s, _ in found):
        return None
    prefills = {p["span_id"]: p for _, p in found}
    tokens = sum(p["args"]["prompt_tokens"] for p in prefills.values())
    if not tokens:
        return None
    return 1e6 * sum(s["args"]["device_s"] for s, _ in found) / tokens
