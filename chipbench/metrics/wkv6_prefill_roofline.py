"""``wkv6``'s prefill calls against their bound: the device time of the
``wkv6_`` kernels (not ``wkv6_backward``) launched in admissions, and per
admission one call a layer of batch 1 over the prompt from zeros."""
from chipbench.readers import (roofline, served_dtype, wkv6_dims,
                               wkv6_forward_work)

PREFIXES = ("wkv6_",)
EXCLUDE = ("wkv6_backward",)


def work(cfg, meta):
    L, H, D = wkv6_dims(cfg)
    size = served_dtype(cfg)[1]
    f, b = wkv6_forward_work(1, meta["tokens"], H, D, size, False)
    return L * f, L * b


def read(run):
    return roofline(run, "prefill", PREFIXES, work,
                    served_dtype(run.cfg)[0], exclude=EXCLUDE)
