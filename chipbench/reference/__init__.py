"""Plain float32 references of the benchmark's configurations, written
from the equations.  They import nothing of ``repro_torch``, ``repro`` or
JAX, and take only tensors the benchmark made."""
