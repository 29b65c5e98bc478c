"""Share of the traced window with no operation on the device, %."""
from portbench import readers

read = readers.idle_share
