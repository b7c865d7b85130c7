"""The three training stages: VAE, latent diffusion, PPO fine-tuning."""
