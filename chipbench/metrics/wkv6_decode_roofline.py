"""``wkv6``'s decode calls against their bound: the device time of the
``wkv6_`` kernels (not ``wkv6_backward``) launched in decode steps, and
per step one call a layer of B slots, T 1, from the state."""
from chipbench.readers import (roofline, served_dtype, wkv6_dims,
                               wkv6_forward_work)

PREFIXES = ("wkv6_",)
EXCLUDE = ("wkv6_backward",)


def work(cfg, meta):
    L, H, D = wkv6_dims(cfg)
    size = served_dtype(cfg)[1]
    f, b = wkv6_forward_work(meta["batch"], 1, H, D, size, True)
    return L * f, L * b


def read(run):
    return roofline(run, "decode_step", PREFIXES, work,
                    served_dtype(run.cfg)[0], exclude=EXCLUDE)
