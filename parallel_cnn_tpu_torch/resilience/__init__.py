"""Resilience helpers the serving slice needs (the retry policy)."""
