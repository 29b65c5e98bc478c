"""The benchmark of `repro_torch`, the PyTorch and CUDA port of P²M.

`run.py` is the entry point; `BENCHMARK.json` at the repository's root
names its cells.  Everything a cell needs is found by name: a
configuration in `configs/<config>.json`, a traffic mix in
`traffic/<traffic>.json`, a cell's comparison limits in
`workloads/<cell>.json`, a per-layer metric's reader in
`metrics/<metric>.py`, and the code that drives a family under a mode in
`drivers/<family>_<mode>.py`.  The plain references in `reference/`
import nothing of the program.
"""
