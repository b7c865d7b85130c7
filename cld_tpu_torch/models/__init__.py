"""Networks: context encoder (ResNet-18 / 34 / 50, average or spatial-softmax
head), temporal UNet and residual-MLP denoisers, the LSTM-VAE with its model
wrapper, and the model zoo's baselines."""
