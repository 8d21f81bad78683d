"""Sync: the fast-sync state download (``fast_sync``)."""
