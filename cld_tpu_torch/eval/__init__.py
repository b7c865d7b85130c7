"""Evaluation: open-loop metrics (ADE / FDE, Wasserstein realism), the
closed-loop evaluator (`cle`) and the named policy composers
(`composers`)."""
