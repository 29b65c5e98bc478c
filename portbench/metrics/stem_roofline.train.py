"""The stem kernels' (forward B1 or B2, B3, B4) summed least time over
their device time in the traced window, %."""
from portbench import readers

read = readers.stem_roofline_train
