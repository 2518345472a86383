"""Arithmetic the engine's metric readers share: the window's
``scheduler_report`` counters and step walls."""
from __future__ import annotations


def counters(run: dict) -> dict:
    """Steps, live slot-steps, decode wall, step walls and admissions of
    the measured window."""
    w = run["window"]
    a, b = w.report0, w.report1
    return {"steps": b["steps"] - a["steps"],
            "active_slot_steps": (b["slot_occupancy"] * b["steps"]
                                  - a["slot_occupancy"] * a["steps"])
            * b["batch_size"],
            "decode_wall_s": b["decode_wall_s"] - a["decode_wall_s"],
            "step_wall_s": sum(x.end - x.start for x in w.steps),
            "admitted": sum(x.admitted for x in w.steps)}
