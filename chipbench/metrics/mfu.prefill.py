"""The prefills' share of the card's peak for the served dtype (bf16 989,
float32 on TF32 495 TFLOP/s): the model's flops (the config's count,
logits at the last position only) of every admission in the window, over
the host-clock seconds of those admissions, each of which ends with its
first token on the host."""
from chipbench.peaks import flops_peak, peaks
from chipbench.readers import served_dtype, token_flops, window_spans


def read(run):
    spans = window_spans(run, "prefill")
    seconds = sum(s.t1 - s.t0 for s in spans) / 1e9
    if not spans or seconds <= 0:
        return None
    flops = 0.0
    for s in spans:
        T = s.meta["tokens"]
        flops += token_flops(run.cfg, T, T * (T + 1) // 2) \
            - (T - 1) * run.cfg["flops"]["head_per_token"]
    return 100.0 * flops / seconds / flops_peak(
        peaks(run.device_kind()), served_dtype(run.cfg)[0])
