"""Visualization: raster-frame prediction plots and world-frame rollout
renders (matplotlib and Pillow, imported only when a render is made)."""
