# Request journeys: the admission handoff.
#
# The port's own copy of note_admission from
# aiko_services_tpu/observe/journey.py: the serving pipeline records each
# admission verdict and its measured fair-queue wait under the frame's
# trace id just before the walk runs, for the request journey a decoder
# reached inside that walk may claim (take_admission_note).  The journeys
# themselves (RequestJourney, JourneyLog) come with the decoder's
# journeys (ROADMAP.md Queue 1 item 3).  The verdict counters and wait
# histograms live in ops/admission.py under the JAX package's family
# names (admission_admitted_total, admission_shed_total,
# admission_rejected_total, admission_queue_wait_seconds).

from __future__ import annotations

from collections import OrderedDict

__all__ = ["note_admission", "take_admission_note"]

_NOTE_CAP = 512               # pending admission notes (bounded)

# trace_id -> {"verdict", "queue_wait_s", "tenant", "tier"}; insertion
# ordered so the bound sheds OLDEST — a note whose request died before
# reaching a decoder ages out instead of leaking
_pending_notes: OrderedDict[str, dict] = OrderedDict()


def note_admission(trace_id: str, verdict: str,
                   queue_wait_s: float | None = None,
                   tenant: str = "", tier: int = 1) -> None:
    """Record one admission verdict for the journey that MAY follow.
    Bounded at _NOTE_CAP, oldest shed."""
    if not trace_id:
        return
    _pending_notes[str(trace_id)] = {
        "verdict": str(verdict),
        "queue_wait_s": queue_wait_s,
        "tenant": str(tenant or ""),
        "tier": int(tier),
    }
    _pending_notes.move_to_end(str(trace_id))
    while len(_pending_notes) > _NOTE_CAP:
        _pending_notes.popitem(last=False)


def take_admission_note(trace_id: str) -> dict | None:
    """Claim (and remove) the pending admission note for a trace id."""
    if not trace_id:
        return None
    return _pending_notes.pop(str(trace_id), None)
