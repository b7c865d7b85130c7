"""Networks of the guided pipeline: context encoder, temporal UNet, LSTM
decoder."""
