"""Mean host ms a decode step inside the port's ``engine.step.readback``
span (the wait for the step's tokens: the card's step), over the decode
steps of a traced run's window, which runs the port's spans with no
profiler."""
from chipbench import program

read = program.decode_readback_ms
