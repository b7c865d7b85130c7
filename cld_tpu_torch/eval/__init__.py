"""Evaluation: open-loop metrics (ADE / FDE, Wasserstein realism) and the
closed-loop evaluator (`cle`)."""
