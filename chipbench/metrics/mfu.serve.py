"""The whole serving loop's share of the card's peak for the served
dtype (bf16 989, float32 on TF32 495 TFLOP/s): the model's
flops (the config's count) for every prefill and decode token of the
spans inside the traced stretch, over the stretch's seconds."""
from chipbench.peaks import flops_peak, peaks
from chipbench.readers import served_dtype, stretch_spans, token_flops


def read(run):
    st = run.stretch
    if st is None or st.seconds <= 0:
        return None
    flops = 0.0
    for s in stretch_spans(run, "decode_step"):
        flops += token_flops(run.cfg, s.meta["active"], s.meta["ctx_active"])
    for s in stretch_spans(run, "prefill"):
        T = s.meta["tokens"]     # logits at the last position only
        flops += token_flops(run.cfg, T, T * (T + 1) // 2) \
            - (T - 1) * run.cfg["flops"]["head_per_token"]
    if not flops:
        return None
    return 100.0 * flops / st.seconds / flops_peak(
        peaks(run.device_kind()), served_dtype(run.cfg)[0])
