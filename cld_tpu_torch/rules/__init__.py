"""Differentiable signal temporal logic for traffic rules."""
