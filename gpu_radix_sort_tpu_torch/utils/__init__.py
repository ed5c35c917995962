"""Key generation, oracles and timers."""
