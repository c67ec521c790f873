"""Training (PyTorch port of ``repro.train``): ``optimizer`` (AdamW with
float32 master weights, global-norm clip, warmup + cosine schedule) and
``step`` (cross-entropy, the loss with the MoE aux, the train step with
microbatch accumulation)."""
