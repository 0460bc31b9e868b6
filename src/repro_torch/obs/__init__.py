"""Coalition-dynamics observables (no extra sweep over W)."""
