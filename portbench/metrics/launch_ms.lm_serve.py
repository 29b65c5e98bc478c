"""Mean host time of the ServeEngine ticks in the window (the
program's own launch_wall_us), ms."""
from portbench import readers

read = readers.launch_ms
