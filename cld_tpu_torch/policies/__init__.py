"""Policies `(obs, rng) -> Action` for the closed-loop simulator."""
