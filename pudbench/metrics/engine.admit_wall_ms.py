"""Host wall of one admission inside the engine: the mean ``engine.admit``
span (``_admit_slot`` whole: the batch-1 prefill's enqueue, its cache
lane, its first token's read) over the measured window, in ms.  The
inside counterpart of ``engine.admit_ms``, which charges a step's wall
outside its decode wave to its admissions."""
from pudbench.harness import program


def read(run):
    spans = program.window_spans(run)
    if spans is None:
        return None
    walls = program.durations_ms(spans, "engine.admit")
    return sum(walls) / len(walls) if walls else None
