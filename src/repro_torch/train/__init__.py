"""Training: the VWW train step and gradient compression; port of
`repro.train` (vision part)."""
