"""Networks: context encoder, temporal UNet, and the LSTM-VAE with its model
wrapper."""
