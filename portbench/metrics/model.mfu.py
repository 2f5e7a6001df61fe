"""model.mfu: model FLOPs of the tokens processed while the wrappers
counted (the window outside the profiled span: the prefill forward tokens
and the decode rows x steps the backend ran, with attention over each
token's live ring), over that time x the card's bf16 peak, in %.  FLOPs
from the configuration file (``roofline.model_flops``)."""
from portbench import roofline


def read(r):
    rec = r.recorder
    if rec is None or not (rec.decode or rec.prefill_tokens):
        return None
    toks = sum(rows * n for rows, n, _ in rec.decode)
    pairs = sum(p for _, _, p in rec.decode)
    for start, n in rec.prefill_tokens:
        toks += n
        pairs += n * start + n * (n + 1) // 2
    flops = roofline.model_flops(r.cell.config, toks, pairs)
    return 100.0 * flops / (rec.on_s * roofline.PEAK_BF16_FLOPS)
