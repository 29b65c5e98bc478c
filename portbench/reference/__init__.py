"""Plain references, in PyTorch and NumPy, written from the papers'
equations.  They import nothing of the program, take nothing the
program made, and run float32 products in float32 unless the caller
turns TF32 on (the control)."""
