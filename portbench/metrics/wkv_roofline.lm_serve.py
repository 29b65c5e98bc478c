"""B7's share of its roofline at the serving tick's shape in the traced
window, %."""
from portbench import readers

read = readers.wkv_roofline
