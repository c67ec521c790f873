"""Ms in which the card was idle while the host was inside the port's
``model.prefill`` span, per thousand prompt tokens of the admissions of
the traced stretch."""
from chipbench import program

read = program.prefill_launch_idle_ms_per_ktok
