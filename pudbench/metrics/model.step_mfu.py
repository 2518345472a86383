"""Model FLOPs of the tokens the traced stretch processed (its prefills
and decode rows; ``harness/counts.model_flops``) over the stretch's
seconds at the chip's bf16 peak, in %."""
from pudbench.harness.counts import model_flops


def read(run):
    st, tr, pk = run["stretch"], run["trace"], run["peaks"]
    if st is None or tr is None or pk is None or tr.window_s <= 0:
        return None
    flops = model_flops(run["config"], st["prompts"], st["decode_positions"])
    return 100.0 * flops / (tr.window_s * pk["bf16_flops"])
