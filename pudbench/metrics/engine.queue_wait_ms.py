"""90th percentile, over the requests admitted in the measured window, of
their ``engine.queue`` spans: from ``submit()`` to the start of their
``engine.admit`` (program spans, host clock), in ms."""
from pudbench.harness import program
from pudbench.harness.stats import percentile


def read(run):
    spans = program.window_spans(run)
    if spans is None:
        return None
    admitted = {s.request for s in spans if s.name == "engine.admit"}
    queued = {s.request: s for s in program.tracer().spans()
              if s.name == "engine.queue" and s.request in admitted}
    if not admitted or len(queued) != len(admitted):
        return None
    return percentile(program.durations_ms(queued.values(), "engine.queue"),
                      90)
