"""Domain records the state-root pipeline needs (accounts)."""
