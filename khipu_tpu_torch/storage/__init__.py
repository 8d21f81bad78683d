"""Node stores the state-root pipeline reads and persists into."""
