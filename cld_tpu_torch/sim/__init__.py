"""The closed-loop simulator: scenes, observation rendering, stepping, metrics."""
