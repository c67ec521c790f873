"""Mean host ms a decode step inside the port's ``model.decode`` span (on
a card, the launch of the step's replayed graph), over the decode steps
of a traced run's window, which runs the port's spans with no profiler."""
from chipbench import program

read = program.decode_launch_ms
