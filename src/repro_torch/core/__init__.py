"""P²M core numerics: pixel model, ADC, the in-pixel conv, BN fold, PTQ."""
