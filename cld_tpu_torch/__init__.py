"""cld_tpu_torch — the PyTorch + CUDA port of cld_tpu for one NVIDIA H100.

The package runs the guided open-loop latent-diffusion pipeline
(`pipeline.guided_collect`: context encode, 100-step DDPM sampling of the
temporal UNet with a per-step Adam perturbation through the frozen LSTM
decoder and the unicycle dynamics, decode, reward), the guided closed loop
(`sim.env.simulate`, `python -m cld_tpu_torch.rollout`), the three training
stages (`training`, `python -m cld_tpu_torch.train --mode vae|dm|ppo`), the
model zoo's eleven baseline algos (`training/zoo.py`, `--mode zoo`), the GAN,
the EBM learned metric and scene diffusion (`--mode gan|ebm|scene_dm`, the
rollout CLI's `--ebm-ckpt`, `policies/scene_policy.py`), the latent attack
(`algos/latent_attack.py`), the 24 policy composers (`eval/composers.py`,
the rollout CLI's `--composer`), renders (`viz/render.py`, `--render`) and
data-parallel training under torchrun (`parallel/mesh.py`). Ten
hand-written CUDA kernels carry its hot paths (`csrc/`): the fused 2-layer
LSTM forward and its reverse sweep, the map gathers, the rigid map distance,
and the reward's off-road count and disk-collision penalty.

Dispatch rule: a kernel wrapper looks at the device of the tensor it is
given. A CUDA tensor launches the kernel (or the wrapper raises); a CPU
tensor takes the kernel's plain PyTorch version. Entry points take an
explicit ``device=`` that defaults to ``"cuda"``.

The package imports torch and numpy only; it keeps its own copy of every
piece of the JAX package it needs.
"""
