"""``decode_attn`` against its bound: the device time of the
``decode_split`` and ``decode_merge`` kernels launched in decode steps.
Per step and attention application (the configuration's
``derived.attention_applications``), one call over every slot: q read
and the output written in the served dtype, each slot's K and V read up to its
length, the lengths read; 4 flops a position, head and channel."""
from chipbench.readers import roofline, served_dtype

PREFIXES = ("decode_split", "decode_merge")


def work(cfg, meta):
    m = cfg["model"]
    apps = cfg["derived"]["attention_applications"]
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    B, ctx = meta["batch"], meta["ctx_all"]
    size = served_dtype(cfg)[1]
    flops = 4.0 * ctx * H * hd
    nbytes = (2.0 * ctx * Hkv * hd + 2 * B * H * hd) * size + 4 * B
    return apps * flops, apps * nbytes


def read(run):
    return roofline(run, "decode_step", PREFIXES, work,
                    served_dtype(run.cfg)[0])
