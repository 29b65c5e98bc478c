"""3 × forward FLOPs an image × images a second over the peak, %."""
from portbench import readers

read = readers.mfu_images
