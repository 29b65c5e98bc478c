"""2·N·tokens advanced a second over the peak, %."""
from portbench import readers

read = readers.mfu_tokens
