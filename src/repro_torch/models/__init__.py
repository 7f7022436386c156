"""Models that federate (the paper's CNN)."""
