"""Token data for training (a copy of ``repro.data``, numpy only)."""
