"""Guidance losses written as source code (port of
`cld_tpu/guidance/codegen.py`): the reference asks an LLM to write a loss
function for a rule given in words and executes it. The query needs a
caller-supplied `query_fn` (nothing here reaches a network); turning a
source string into a GuidanceSpec works on its own.

SECURITY: `loss_from_source` executes arbitrary Python. Only feed it trusted
strings.
"""

from __future__ import annotations

from typing import Callable, Optional

from cld_tpu_torch.guidance.perturbation import GuidanceSpec

LOSS_TEMPLATE_DOC = """
A generated loss must define:

    def guidance_loss(x, ctx, agt_mask=None):
        # x: [B, N, T, 6] torch.Tensor, descaled (x, y, vel, yaw, acc, yawvel)
        # ctx: cld_tpu_torch.guidance.losses.GuidanceContext
        # returns a [B, N] torch.Tensor, differentiable in x
"""


def loss_from_source(source: str, weight: float = 1.0) -> GuidanceSpec:
    """Compile a loss function's PyTorch source (`torch` is in its
    namespace) into a GuidanceSpec."""
    import torch

    namespace = {"torch": torch}
    exec(compile(source, "<guidance_codegen>", "exec"), namespace)
    fn = namespace.get("guidance_loss")
    if fn is None:
        raise ValueError("source must define guidance_loss(x, ctx, agt_mask=None)")
    return GuidanceSpec(fn, weight)


def query_llm_for_loss(rule_text: str, query_fn: Optional[Callable[[str], str]] = None,
                       weight: float = 1.0) -> GuidanceSpec:
    """Ask an LLM, through `query_fn(prompt) -> source`, to write a loss for a
    rule given in words; raises without `query_fn`."""
    if query_fn is None:
        raise RuntimeError(
            "no LLM access in this environment; pass query_fn (prompt -> python source) or "
            "use loss_from_source with prepared code"
        )
    prompt = ("Write a PyTorch guidance loss for this traffic rule. " + LOSS_TEMPLATE_DOC
              + f"\nRule: {rule_text}\nReturn only Python source.")
    return loss_from_source(query_fn(prompt), weight)
