"""Recommender models: the factorization machine."""
